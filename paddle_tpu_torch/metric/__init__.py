"""paddle.metric for the port: the host-side metrics ``Model`` reads."""
from .metrics import Accuracy, Auc, Metric, Precision, Recall

__all__ = ["Accuracy", "Auc", "Metric", "Precision", "Recall"]

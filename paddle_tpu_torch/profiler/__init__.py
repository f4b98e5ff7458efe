"""``paddle.profiler`` for the port: the ``Profiler`` state machine with
host op events and a ``torch.profiler`` device timeline
(``profiler.py``), and the training loop's and serving's statistics
(``pipeline.py``)."""
from .pipeline import PipelineStats, ServingStats, pipeline_stats
from .profiler import (Profiler, ProfilerState, ProfilerTarget, RecordEvent,
                       SortedKeys, export_chrome_tracing, make_scheduler)

__all__ = ["PipelineStats", "Profiler", "ProfilerState", "ProfilerTarget",
           "RecordEvent", "ServingStats", "SortedKeys",
           "export_chrome_tracing", "make_scheduler", "pipeline_stats"]

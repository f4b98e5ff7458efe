"""``DistributedStrategy``: the layered configuration of hybrid-parallel
training (port of ``paddle_tpu/distributed/fleet/strategy.py``).

Reference: fleet/base/distributed_strategy.py:284 (protobuf-backed, dozens
of toggles). The widely used surface is kept as plain Python state; the
sections mirror the reference's field groups (amp, recompute, sharding,
hybrid_configs, gradient_merge, ...). :meth:`DistributedStrategy.
to_degrees` maps ``hybrid_configs`` onto the mesh's five axes
(``env.HYBRID_AXES``).
"""
from __future__ import annotations

__all__ = ["DistributedStrategy"]


class _Section(dict):
    """A dict whose keys read and write as attributes."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v


class DistributedStrategy:
    def __init__(self):
        self.amp = False
        self.amp_configs = _Section(
            init_loss_scaling=65536.0,
            use_dynamic_loss_scaling=True,
            custom_white_list=[],
            custom_black_list=[],
            use_pure_fp16=False,
            use_bf16=True,
        )
        self.recompute = False
        self.recompute_configs = _Section(checkpoints=[])
        self.sharding = False
        self.sharding_configs = _Section(stage=1, degree=1, offload=False)
        self.hybrid_configs = _Section(
            dp_degree=-1,
            mp_degree=1,
            pp_degree=1,
            sharding_degree=1,
            sep_degree=1,
            pp_configs=_Section(micro_batch_size=1, accumulate_steps=1),
        )
        self.gradient_merge = False
        self.gradient_merge_configs = _Section(k_steps=1, avg=True)
        self.lamb = False
        self.lars = False
        self.dgc = False
        self.localsgd = False
        self.gradient_scale_configs = _Section(scale_strategy="avg")
        self.pipeline = False
        self.pipeline_configs = _Section(accumulate_steps=1,
                                         micro_batch_size=1,
                                         schedule_mode="1F1B")
        self.without_graph_optimization = False
        self.fuse_all_reduce_ops = True  # kept for surface compatibility
        self.find_unused_parameters = False
        self.tensor_parallel = False
        self.tensor_parallel_configs = _Section(tensor_parallel_degree=1)

    def to_degrees(self):
        """``hybrid_configs`` as mesh axis degrees (``env.HYBRID_AXES``)."""
        hc = self.hybrid_configs
        return {
            "dp": hc.get("dp_degree", -1),
            "mp": hc.get("mp_degree", 1),
            "pp": hc.get("pp_degree", 1),
            "sharding": hc.get("sharding_degree", 1),
            "sep": hc.get("sep_degree", 1),
        }

    def __setattr__(self, k, v):
        # a plain dict assigned to a *_configs section merges into it
        if (k.endswith("_configs") and isinstance(v, dict)
                and not isinstance(v, _Section)):
            base = getattr(self, k, _Section())
            merged = _Section(base)
            for kk, vv in v.items():
                merged[kk] = (_Section(vv) if isinstance(vv, dict)
                              and isinstance(base.get(kk), dict) else vv)
            object.__setattr__(self, k, merged)
        else:
            object.__setattr__(self, k, v)

"""Pipeline parallelism: model surgery and its runtime (port of
``paddle_tpu/distributed/fleet/pipeline.py``).

Reference: fleet/meta_parallel/parallel_layers/pp_layers.py — LayerDesc
(:57), SharedLayerDesc (:77), SegmentLayers (:93), PipelineLayer (:258);
the runtime schedules in fleet/meta_parallel/pipeline_parallel.py.

``PipelineLayer`` runs the longest run of identical ``LayerDesc`` s as a
``PipelinedStack`` (``pipeline_schedules``: one process a stage, this
rank holding its stage's layers) when the mesh's ``pp`` axis has
``num_stages`` ranks; the layers before and after it (embedding, final
norm, head) are built whole on every ``pp`` rank, which the stack's
contract keeps equal (the JAX package shards their largest dim over ``pp``
for memory only; the port keeps them whole). A list with no such run, or a
mesh without those ranks, runs whole on every rank, as the JAX package's
full-graph composition does. ``SharedLayerDesc`` ties one layer between
its occurrences; ``recompute_interval`` routes every k-th layer through
``fleet.recompute``.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from ...nn.layer.layers import Layer


class LayerDesc:
    """Deferred layer construction (reference pp_layers.py:57)."""

    def __init__(self, layer_cls, *inputs, **kwargs):
        self.layer_cls = layer_cls
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self) -> Layer:
        return self.layer_cls(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    """A layer tied between its occurrences (reference :77): the
    embedding and the LM head of the first and last stages."""

    def __init__(self, key, layer_cls, *inputs, forward_func=None,
                 shared_weight_attr="weight", **kwargs):
        super().__init__(layer_cls, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    """Split N layers into num_parts segments (reference :93): 'uniform' or
    'layer' (param-count balanced)."""

    def __init__(self, layers, num_parts, method="uniform"):
        self.layers = layers
        self.num_parts = num_parts
        self.method = method

    def do_segment(self) -> List[int]:
        n = len(self.layers)
        if self.method == "uniform" or not self.method.startswith("param"):
            base = n // self.num_parts
            rem = n % self.num_parts
            bounds = [0]
            for i in range(self.num_parts):
                bounds.append(bounds[-1] + base + (1 if i < rem else 0))
            return bounds
        weights = []
        for l in self.layers:
            if isinstance(l, Layer):
                weights.append(max(1, sum(int(np.prod(p.shape))
                                          for p in l.parameters())))
            else:
                weights.append(1)
        total = sum(weights)
        target = total / self.num_parts
        bounds, acc = [0], 0
        for i, w in enumerate(weights):
            acc += w
            if acc >= target * len(bounds) and len(bounds) < self.num_parts:
                bounds.append(i + 1)
        while len(bounds) < self.num_parts + 1:
            bounds.append(len(weights))
        return bounds


def _same_desc(a, b) -> bool:
    """Identical constructor calls, not just the class: the stack builds
    every layer of the run from one desc."""
    return (isinstance(a, LayerDesc) and isinstance(b, LayerDesc)
            and not isinstance(a, SharedLayerDesc)
            and not isinstance(b, SharedLayerDesc)
            and a.layer_cls is b.layer_cls
            and a.inputs == b.inputs and a.kwargs == b.kwargs)


def _longest_run(descs) -> tuple:
    lo_best = hi_best = 0
    lo = 0
    while lo < len(descs):
        hi = lo
        while hi < len(descs) and _same_desc(descs[hi], descs[lo]):
            hi += 1
        if hi - lo > hi_best - lo_best:
            lo_best, hi_best = lo, hi
        lo = max(hi, lo + 1)
    return lo_best, hi_best


class PipelineLayer(Layer):
    """A segmented model (reference pp_layers.py:258; module notes)."""

    def __init__(
        self,
        layers: Sequence[Union[Layer, LayerDesc, Callable]],
        num_stages: Optional[int] = None,
        topology=None,
        loss_fn=None,
        seg_method="uniform",
        recompute_interval=0,
        num_virtual_pipeline_stages: int = 1,
        num_microbatches: Optional[int] = None,
        **kwargs,
    ):
        super().__init__()
        from .. import env as env_mod

        self._loss_fn = loss_fn
        self._recompute_interval = recompute_interval
        degrees = env_mod.instance().axis_degrees or {}
        self._num_stages = num_stages or max(degrees.get("pp", 1), 1)
        descs = list(layers)
        self._segment_bounds = SegmentLayers(
            descs, self._num_stages, seg_method).do_segment()
        self._shared_layers = {}
        self._stack = None
        self._stack_range = (0, 0)
        mesh = env_mod.get_mesh()
        mesh_pp = mesh.shape.get("pp", 1) if mesh is not None else 1
        # a stage is a process: stack the run only over that many pp ranks
        if self._num_stages > 1 and mesh_pp == self._num_stages:
            lo, hi = _longest_run(descs)
            per = self._num_stages * max(num_virtual_pipeline_stages, 1)
            n_mid = (hi - lo) - (hi - lo) % per
            if n_mid >= per:
                from .pipeline_schedules import PipelinedStack

                mid = descs[lo]
                self._stack = PipelinedStack(
                    mid.build_layer, n_mid, num_stages=self._num_stages,
                    num_chunks=max(num_virtual_pipeline_stages, 1),
                    num_microbatches=num_microbatches)
                self._stack_range = (lo, lo + n_mid)

        built: List = []
        slo, shi = self._stack_range
        for pos, item in enumerate(descs):
            if self._stack is not None and slo <= pos < shi:
                continue  # lives inside the stack
            if isinstance(item, SharedLayerDesc):
                if item.layer_name in self._shared_layers:
                    src = self._shared_layers[item.layer_name]
                    built.append(_SharedForward(src, item.forward_func))
                else:
                    layer = item.build_layer()
                    self._shared_layers[item.layer_name] = layer
                    built.append(layer)
            elif isinstance(item, LayerDesc):
                built.append(item.build_layer())
            else:
                built.append(item)
            if self._stack is not None and pos == slo - 1:
                built.append(self._stack)
        if self._stack is not None and slo == 0:
            built.insert(0, self._stack)
        from ...nn.layer.container import LayerList

        self.run_function = LayerList([l for l in built
                                       if isinstance(l, Layer)])
        self._funcs = built

    def get_stage_from_index(self, idx) -> int:
        for si in range(self._num_stages):
            if self._segment_bounds[si] <= idx < self._segment_bounds[si + 1]:
                return si
        return self._num_stages - 1

    @property
    def parameters_in_stage(self):
        return self._segment_bounds

    def forward(self, x):
        out = x
        for i, fn in enumerate(self._funcs):
            if (self._recompute_interval and isinstance(fn, Layer)
                    and i % self._recompute_interval == 0):
                from .recompute import recompute

                out = recompute(fn, out)
            else:
                out = fn(out)
        return out


class _SharedForward(Layer):
    def __init__(self, src_layer, forward_func):
        super().__init__()
        # not a sublayer: the weights are the first occurrence's
        object.__setattr__(self, "_src", [src_layer])
        self._forward_func = forward_func

    def forward(self, x):
        src = self._src[0]
        if self._forward_func is not None:
            return self._forward_func(src, x)
        return src(x)


class PipelineParallel(Layer):
    """Schedule runtime (reference pipeline_parallel.py:255).

    ``train_batch(batch, optimizer, lr_scheduler)`` splits the batch into
    ``pipeline_configs["accumulate_steps"]`` parts, each a forward and a
    backward of ``loss / steps`` (the stack inside pipelines each part's
    microbatches), then one optimizer step."""

    def __init__(self, layers: PipelineLayer, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._strategy = strategy
        cfg = (getattr(strategy, "pipeline_configs", None)
               if strategy else None)
        self._accumulate_steps = (int(cfg.get("accumulate_steps", 1))
                                  if cfg else 1)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        x, y = data
        steps = max(self._accumulate_steps, 1)
        micro_x = list(x.chunk(steps, 0)) if steps > 1 else [x]
        micro_y = list(y.chunk(steps, 0)) if steps > 1 else [y]
        total = None
        for mx, my in zip(micro_x, micro_y):
            out = self._layers(mx)
            loss = self._layers._loss_fn(out, my)
            if scaler is not None:
                scaler.scale(loss / steps).backward()
            else:
                (loss / steps).backward()
            total = loss.detach() if total is None else total + loss.detach()
        if scaler is not None:
            scaler.step(optimizer)
            scaler.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return total / steps

    def eval_batch(self, data, compute_loss=True):
        x, y = data
        out = self._layers(x)
        return self._layers._loss_fn(out, y) if compute_loss else out

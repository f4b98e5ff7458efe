"""The parallel layouts' pieces that GPT, Llama and BERT share: the
tensor-parallel linear classes of a config, the ``sep`` place of this
rank and its part of a sequence, the parameters that sequence parallelism
marks, the random stream of rank-local tensors, the pipelined stack of a
config's blocks and the initialization that walks it. The fleet modules
are imported when a layout asks for them, so a single-device model never
loads the distributed tier."""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch


def linears(config) -> Tuple[type, type]:
    """The column- and row-parallel linear classes of a tensor-parallel
    ``config``: the sequence-parallel ones under ``sequence_parallel``."""
    if getattr(config, "sequence_parallel", False):
        from ..distributed.fleet.sequence_parallel import (
            ColumnSequenceParallelLinear, RowSequenceParallelLinear)

        return ColumnSequenceParallelLinear, RowSequenceParallelLinear
    from ..distributed.fleet.mpu import ColumnParallelLinear, RowParallelLinear

    return ColumnParallelLinear, RowParallelLinear


def vocab_embedding(num, dim):
    from ..distributed.fleet.mpu import VocabParallelEmbedding

    return VocabParallelEmbedding(num, dim)


def sep_place(config) -> Tuple[int, int]:
    """``(degree, coordinate)`` of this rank on ``sep`` for a
    context-parallel ``config``, else ``(1, 0)``."""
    if not getattr(config, "context_parallel", ""):
        return 1, 0
    from ..distributed.fleet.mpu import group_comm

    c = group_comm("sep")
    return c.n, c.me


def seq_part(t: torch.Tensor, n: int, r: int, dim: int = -1) -> torch.Tensor:
    """Rank ``r``'s contiguous part of ``t``'s dim ``dim`` over ``n``."""
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"sequence length {size} does not split over "
                         f"sep={n}")
    part = size // n
    return t.narrow(dim, r * part, part)


def mark_sequence_parallel(config, *layers) -> None:
    """Under ``sequence_parallel``, every parameter of ``layers`` (the
    norms that act on sequence-cut activations) marked: its gradient is a
    partial sum over ``mp``."""
    if not config.sequence_parallel:
        return
    for layer in layers:
        for p in layer.parameters():
            p.sequence_parallel = True


def local_generator(device) -> torch.Generator:
    """The RNG tracker's ``model_parallel_rng`` on ``device``: the stream of
    dropout on tensors that differ by ``mp`` rank."""
    from ..distributed.fleet.mpu import get_rng_state_tracker

    return get_rng_state_tracker().generator(device=device)


def mp_degree() -> int:
    from ..distributed.fleet.mpu import mp_degree as degree

    return degree()


@torch.no_grad()
def normal_(module: torch.nn.Module, name: str, std: float,
            gen: torch.Generator) -> None:
    """``module.<name>`` drawn normal(0, ``std``) from ``gen``; a parameter
    cut over ``mp`` takes its part of the whole one drawn."""
    if name in getattr(module, "_shard_specs", {}):
        from ..distributed.fleet.mpu import normal_ as cut_normal_

        cut_normal_(module, name, 0.0, std, gen)
    else:
        getattr(module, name).normal_(0.0, std, generator=gen)


def shard_specs(model: torch.nn.Module) -> Dict[str, object]:
    """``model``'s parameters cut over ``mp``, by name (none for a
    single-device model)."""
    if not any(getattr(m, "_shard_specs", None) for m in model.modules()):
        return {}
    from ..distributed.fleet.mpu import sharded_params

    return sharded_params(model)


def blocks(config, factory: Callable[[], torch.nn.Module]):
    """The decoder blocks of ``config``: a ``fleet`` ``PipelinedStack`` of
    ``factory``'s layers under ``pipeline_parallel`` (its schedule
    ``config.pp_schedule`` where the config has one, else ``"rotation"``),
    else a ``ModuleList``."""
    n = config.num_hidden_layers
    if not config.pipeline_parallel:
        return torch.nn.ModuleList([factory() for _ in range(n)])
    from ..distributed.fleet.pipeline_schedules import PipelinedStack

    return PipelinedStack(
        factory, num_layers=n, num_chunks=max(config.virtual_pp_degree, 1),
        num_microbatches=config.pp_num_microbatches or None,
        schedule=getattr(config, "pp_schedule", "rotation"))


def run_blocks(config, blocks_, x):
    """``x`` through the decoder blocks (:func:`blocks`)."""
    if config.pipeline_parallel:
        return blocks_(x)
    for block in blocks_:
        x = block(x)
    return x


@torch.no_grad()
def init_modules(model: torch.nn.Module,
                 init: Callable[[str, torch.nn.Module], None]) -> None:
    """``init(name, module)`` on every module of ``model`` in
    ``named_modules`` order; a pipelined stack's layers are initialized as
    a serial list's would be, layer by layer with their own module names
    (``PipelinedStack.init_stacked``), and its template is not visited,
    so one generator gives a pipelined model the weights of the serial
    one."""
    skip = None
    for name, mod in model.named_modules():
        if skip is not None and name.startswith(skip):
            continue
        stacked = getattr(mod, "init_stacked", None)
        if stacked is not None:
            stacked(lambda layer: [init(n, m)
                                   for n, m in layer.named_modules()])
            skip = f"{name}.template"
            continue
        init(name, mod)

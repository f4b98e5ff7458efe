"""The parallel layouts' pieces that GPT, Llama and BERT share: the
tensor-parallel linear classes of a config, the ``sep`` place of this
rank and its part of a sequence, the parameters that sequence parallelism
marks, and the random stream of rank-local tensors. The fleet modules are
imported when a layout asks for them, so a single-device model never
loads the distributed tier."""
from __future__ import annotations

from typing import Dict, Tuple

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

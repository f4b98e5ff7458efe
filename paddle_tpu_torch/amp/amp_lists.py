"""AMP op lists (the port's copy of ``paddle_tpu/amp/amp_lists.py``).

White list: ops numerically safe and fast in low precision. Black list: ops
that must compute in f32. Everything else is gray: under O1 it runs in the
dtype of its inputs; under O2 every op but the black list runs in the AMP
dtype. The port's functionals name themselves by these op names.

The JAX lists are the hand lists below joined with a classification of
every op of its registry (``paddle_tpu/ops/registry.py`` ``amp_white`` and
``amp_black``). The port keeps its own copy of that classification for the
op names its functionals pass to ``cast_inputs`` that the hand lists do
not name (:data:`REGISTRY_WHITE`, :data:`REGISTRY_BLACK`); the rest of
them (``swiglu``, ``fused_rope``, ``calc_reduced_attn_scores``) are gray
there too.
"""

WHITE_LIST = frozenset({
    "matmul", "mm", "bmm", "linear", "einsum", "addmm",
    "conv1d", "conv2d", "conv3d", "conv1d_transpose", "conv2d_transpose",
    "conv3d_transpose",
    "flash_attention", "flash_attention_xla", "sdpa_flash", "sdpa_xla",
    "pallas_rms_norm",
})

BLACK_LIST = frozenset({
    "exp", "square", "log", "log2", "log10", "log1p", "mean", "sum", "cumsum",
    "softmax", "log_softmax", "cross_entropy", "bce_with_logits",
    "binary_cross_entropy", "nll_loss", "kl_div", "logsumexp",
    "layer_norm", "rms_norm", "batch_norm", "batch_norm_infer", "group_norm",
    "instance_norm", "norm", "cosine_similarity", "softmax_with_cross_entropy",
    "prod", "std", "var", "logcumsumexp", "erfinv", "pow", "ctc_loss",
})

#: the registry's classification of the port's other op names
REGISTRY_WHITE = frozenset({"flash_attn_unpadded", "flashmask_attention"})
REGISTRY_BLACK = frozenset({"fused_softmax_mask",
                            "fused_softmax_mask_upper_triangle"})


def white_list() -> set:
    """The hand list joined with the registry's white ops."""
    return set(WHITE_LIST) | REGISTRY_WHITE


def black_list() -> set:
    """The hand list joined with the registry's black ops that the white
    list does not name."""
    return set(BLACK_LIST) | (REGISTRY_BLACK - WHITE_LIST)

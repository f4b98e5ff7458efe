"""The losses of ``nn.functional`` and ``nn`` against the JAX package on
the CPU: every loss in ``none``/``mean``/``sum`` (``batchmean`` for
``kl_div``), with ``weight``, ``pos_weight``, ``ignore_index``,
``log_target``, ``swap`` and ``normalizer`` where they apply, values
within 1e-5 relative and the input's gradient (``mean``) within 1e-4 of
its largest magnitude; each loss layer against its JAX layer. Where the
JAX function's reduction is a plain mean or sum of its ``none`` losses,
the port's is held to that of JAX's ``none`` losses (one JAX compile a
loss, not three).

``ctc_loss``: ``none`` and ``mean`` (its own reduction: each loss over its
label length), and the ``mean``'s gradient with respect to raw
log-probabilities (not a ``log_softmax`` output) and through
``log_softmax``, with input lengths
below T and labels with repeats, against JAX's autodiff; torch's native
``ctc_loss`` is held apart, its gradient on raw log-probabilities being
another function's. ``nll_loss`` with ``ignore_index``: the JAX function
returns NaN at the ignored positions (its gather is out of range); the
port zeroes them, and is held to JAX over the valid rows."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as paddle
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch import nn

RTOL = 1e-5
GRAD = 1e-4
N, C = 6, 5


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(device_mod, "_chosen", None)
    paddle.set_device("cpu")


def _np(x):
    if isinstance(x, (np.ndarray, np.generic)):
        return np.asarray(x)
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x.numpy())


def _inputs():
    rs = np.random.RandomState(0)
    prob = rs.uniform(0.05, 0.95, (N, C)).astype(np.float32)
    logp = np.log(rs.dirichlet(np.ones(C), N)).astype(np.float32)
    return dict(
        a=rs.randn(N, C).astype(np.float32),
        b=rs.randn(N, C).astype(np.float32),
        c=rs.randn(N, C).astype(np.float32),
        prob=prob, y01=(rs.rand(N, C) > 0.5).astype(np.float32),
        pm1=np.where(rs.rand(N, C) > 0.5, 1.0, -1.0).astype(np.float32),
        logp=logp, cls=rs.randint(0, C, N).astype(np.int64),
        w=rs.uniform(0.5, 2.0, C).astype(np.float32),
        wfull=rs.uniform(0.5, 2.0, (N, C)).astype(np.float32),
        target=rs.dirichlet(np.ones(C), N).astype(np.float32),
        norm=np.array(3.0, np.float32))


# name: (differentiated input, other inputs, keywords, reductions)
LOSSES = {
    "mse_loss": ("a", ["b"], {}, ("none", "mean", "sum")),
    "l1_loss": ("a", ["b"], {}, ("none", "mean", "sum")),
    "smooth_l1_loss": ("a", ["b"], {"delta": 0.7}, ("none", "mean", "sum")),
    "binary_cross_entropy": ("prob", ["y01"], {}, ("none", "mean", "sum")),
    "binary_cross_entropy:weight": ("prob", ["y01", "wfull"], {},
                                    ("mean",)),
    "binary_cross_entropy_with_logits:pos_weight": (
        "a", ["y01", "wfull", "w"], {}, ("none", "mean", "sum")),
    "nll_loss": ("logp", ["cls"], {}, ("none", "mean", "sum")),
    "nll_loss:weight": ("logp", ["cls", "w"], {}, ("none", "mean", "sum")),
    "kl_div": ("logp", ["target"], {}, ("none", "mean", "sum", "batchmean")),
    "kl_div:log_target": ("logp", ["logp2"], {"log_target": True},
                          ("mean",)),
    "margin_ranking_loss": ("a", ["b", "pm1"], {"margin": 0.3},
                            ("none", "mean", "sum")),
    "hinge_embedding_loss": ("a", ["pm1"], {"margin": 0.5},
                             ("none", "mean", "sum")),
    "triplet_margin_loss": ("a", ["b", "c"], {"margin": 0.5},
                            ("none", "mean", "sum")),
    "triplet_margin_loss:swap": ("a", ["b", "c"], {"swap": True, "p": 3.0},
                                 ("mean",)),
    "sigmoid_focal_loss": ("a", ["y01"], {}, ("none", "mean", "sum")),
    "sigmoid_focal_loss:normalizer": ("a", ["y01", "norm"], {},
                                      ("sum",)),
}


def _call(mod, name, arrays, kw, reduction, make):
    fn = getattr(mod, name.split(":")[0])
    if name.startswith("binary_cross_entropy_with_logits"):
        z, y, w, pw = arrays
        return fn(make(z), make(y), make(w), reduction, make(pw))
    if name.startswith("sigmoid_focal_loss"):
        return fn(*[make(a) for a in arrays], reduction=reduction, **kw) \
            if len(arrays) == 2 else fn(make(arrays[0]), make(arrays[1]),
                                        make(arrays[2]), reduction=reduction)
    if name.startswith("nll_loss") or name == "binary_cross_entropy:weight":
        if len(arrays) == 3:
            return fn(make(arrays[0]), make(arrays[1]), make(arrays[2]),
                      reduction=reduction)
    return fn(*[make(a) for a in arrays], reduction=reduction, **kw)


# a plain reduction of the "none" losses, as the JAX ``_reduce`` takes it
# (``nll_loss``'s mean is weighted: JAX computes each of its reductions)
_REDUCE = {"mean": np.mean, "sum": np.sum,
           "batchmean": lambda a: a.sum() / a.shape[0]}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name):
    """Each reduction against JAX's: the JAX function's own where it
    weighs (``nll_loss``) or is the case's only one, else JAX's ``none``
    losses reduced; the ``mean``'s input gradient (else the only
    reduction's) against JAX's gradient of the same reduction."""
    ins = _inputs()
    ins["logp2"] = ins["logp"][::-1].copy()
    wrt, others, kw, reductions = LOSSES[name]
    arrays = [ins[wrt]] + [ins[o] for o in others]
    grad_of = "mean" if "mean" in reductions else reductions[-1]
    derive = "none" in reductions and not name.startswith("nll_loss")

    def jax_loss(reduction):
        xj = jp.to_tensor(arrays[0], stop_gradient=False)
        return xj, _call(JF, name, [xj] + arrays[1:], kw, reduction,
                         lambda a: a if not isinstance(a, np.ndarray)
                         else jp.to_tensor(a))

    if derive:
        xj_none, want_none = jax_loss("none")
    for reduction in reductions:
        xt = torch.from_numpy(arrays[0]).requires_grad_()
        got = _call(F, name, [xt] + arrays[1:], kw, reduction,
                    lambda a: a if isinstance(a, torch.Tensor)
                    else torch.from_numpy(np.asarray(a)))
        if derive and reduction != "none":
            xj, want = None, _REDUCE[reduction](_np(want_none))
        elif derive:
            xj, want = xj_none, want_none
        else:
            xj, want = jax_loss(reduction)
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL,
                                   atol=RTOL, err_msg=f"{name} {reduction}")
        if reduction != grad_of:
            continue
        got.sum().backward()
        if xj is None:  # the plain reduction of JAX's "none" losses
            xj = xj_none
            none = _np(want_none)
            scale = 1.0 / none.size if reduction == "mean" else (
                1.0 / none.shape[0] if reduction == "batchmean" else 1.0)
            (want_none.sum() * scale).backward()
        else:
            want.sum().backward()
        g, jg = _np(xt.grad), _np(xj.grad)
        bound = max(float(np.abs(jg).max()), 1e-6)
        assert float(np.abs(g - jg).max()) <= GRAD * bound, name


def test_regression_losses_without_reduction_match_jax():
    ins = _inputs()
    a, b, p, y = (ins[k] for k in ("a", "b", "prob", "y01"))
    for got, want in (
            (F.square_error_cost(torch.from_numpy(a), torch.from_numpy(b)),
             JF.square_error_cost(jp.to_tensor(a), jp.to_tensor(b))),
            (F.log_loss(torch.from_numpy(p), torch.from_numpy(y), 1e-3),
             JF.log_loss(jp.to_tensor(p), jp.to_tensor(y), 1e-3))):
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=RTOL)


def test_nll_loss_ignore_index_and_spatial_inputs():
    """Ignored labels: JAX's NaN pinned, the port's zero; the valid rows
    and the reductions held to JAX over the valid rows alone."""
    ins = _inputs()
    logp, w = ins["logp"], ins["w"]
    y = ins["cls"].copy()
    y[[1, 4]] = -100
    jnone = _np(JF.nll_loss(jp.to_tensor(logp), jp.to_tensor(y),
                            reduction="none"))
    assert np.isnan(jnone[[1, 4]]).all()
    got = F.nll_loss(torch.from_numpy(logp), torch.from_numpy(y),
                     torch.from_numpy(w), reduction="none").numpy()
    keep = y != -100
    assert (got[~keep] == 0).all()
    for red in ("none", "mean", "sum"):
        want = JF.nll_loss(jp.to_tensor(logp[keep]), jp.to_tensor(y[keep]),
                           jp.to_tensor(w), reduction=red)
        got = F.nll_loss(torch.from_numpy(logp), torch.from_numpy(y),
                         torch.from_numpy(w), reduction=red)
        got = _np(got)[keep] if red == "none" else _np(got)
        np.testing.assert_allclose(got, _np(want), rtol=RTOL, atol=RTOL)
    # [N, C, d]: the class axis second, the label [N, d]
    rs = np.random.RandomState(3)
    lp = np.log(rs.dirichlet(np.ones(C), (2, 3))).transpose(0, 2, 1) \
        .astype(np.float32)
    lab = rs.randint(0, C, (2, 3))
    for red in ("none", "mean"):
        np.testing.assert_allclose(
            _np(F.nll_loss(torch.from_numpy(lp), torch.from_numpy(lab),
                           reduction=red)),
            _np(JF.nll_loss(jp.to_tensor(lp), jp.to_tensor(lab),
                            reduction=red)), rtol=RTOL, atol=RTOL)


def _ctc_case():
    rs = np.random.RandomState(5)
    t, b, c, s = 12, 4, 6, 4
    raw = (rs.randn(t, b, c) * 2).astype(np.float32)  # not normalised
    labels = np.array([[1, 1, 2, 3], [2, 2, 2, 0], [4, 5, 1, 1],
                       [3, 0, 0, 0]], np.int64)  # repeats, pads
    in_len = np.array([12, 9, 12, 5], np.int64)  # some below T
    lab_len = np.array([4, 3, 4, 1], np.int64)
    return raw, labels, in_len, lab_len


@pytest.mark.parametrize("through_log_softmax", [False, True])
def test_ctc_loss_and_gradient_match_jax(through_log_softmax):
    raw, labels, in_len, lab_len = _ctc_case()
    args_t = [torch.from_numpy(a) for a in (labels, in_len, lab_len)]
    args_j = [jp.to_tensor(a) for a in (labels, in_len, lab_len)]
    # "none" and "mean" on raw log-probabilities (the sum is the none
    # losses summed); the mean through log_softmax
    for red in ("mean",) if through_log_softmax else ("none", "mean"):
        xt = torch.from_numpy(raw).requires_grad_()
        xj = jp.to_tensor(raw, stop_gradient=False)
        lp_t = torch.log_softmax(xt, -1) if through_log_softmax else xt
        lp_j = JF.log_softmax(xj, -1) if through_log_softmax else xj
        got = F.ctc_loss(lp_t, *args_t, blank=0, reduction=red)
        want = JF.ctc_loss(lp_j, *args_j, blank=0, reduction=red)
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL,
                                   atol=RTOL, err_msg=red)
        if red == "none":
            np.testing.assert_allclose(
                _np(F.ctc_loss(lp_t, *args_t, reduction="sum")),
                _np(want).sum(), rtol=RTOL)
            continue
        got.backward()
        want.backward()
        g, jg = _np(xt.grad), _np(xj.grad)
        assert float(np.abs(g - jg).max()) <= GRAD * float(
            np.abs(jg).max()), red
        # no gradient past a sequence's length
        assert (g[9:, 1] == 0).all() and (g[5:, 3] == 0).all()
    if not through_log_softmax:
        # torch's native CTC on the same raw input gives another gradient,
        # so the port does not use it
        xt = torch.from_numpy(raw).requires_grad_()
        native = torch.nn.functional.ctc_loss(
            xt, *args_t, blank=0, reduction="sum", zero_infinity=False)
        native.backward()
        assert float(np.abs(_np(xt.grad) - jg).max()) > 0.1


LAYERS = [
    # port/JAX class, constructor kwargs, input names
    ("MSELoss", {}, ["a", "b"]),
    ("L1Loss", {"reduction": "sum"}, ["a", "b"]),
    ("SmoothL1Loss", {"delta": 0.5}, ["a", "b"]),
    ("BCELoss", {"reduction": "none"}, ["prob", "y01"]),
    ("BCEWithLogitsLoss", {}, ["a", "y01"]),
    ("NLLLoss", {"reduction": "sum"}, ["logp", "cls"]),
    ("KLDivLoss", {"reduction": "batchmean"}, ["logp", "target"]),
    ("MarginRankingLoss", {"margin": 0.2}, ["a", "b", "pm1"]),
    ("TripletMarginLoss", {"margin": 0.7}, ["a", "b", "c"]),
    ("HingeEmbeddingLoss", {"reduction": "none"}, ["a", "pm1"]),
]


def test_loss_layers_match_jax():
    ins = _inputs()
    for name, kw, names in LAYERS:
        got = getattr(nn, name)(**kw)(
            *[torch.from_numpy(ins[k]) for k in names])
        want = getattr(jnn, name)(**kw)(*[jp.to_tensor(ins[k])
                                          for k in names])
        assert isinstance(got, paddle.Tensor), name
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL,
                                   atol=RTOL, err_msg=name)
    raw, labels, in_len, lab_len = _ctc_case()
    got = nn.CTCLoss(blank=0, reduction="sum")(
        *[torch.from_numpy(a) for a in (raw, labels, in_len, lab_len)])
    want = jnn.CTCLoss(blank=0, reduction="sum")(
        *[jp.to_tensor(a) for a in (raw, labels, in_len, lab_len)])
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL)

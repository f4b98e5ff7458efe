"""``paddle.Tensor`` of the port against the JAX package's, on the CPU.

- Its properties (``shape`` a list, ``size`` the element count, ``place``,
  ``stop_gradient``, ``T``, ``numpy``, ``item``, ``tolist``, ``astype``) and
  operators (arithmetic with tensors and numbers on either side, the
  comparisons, the bitwise and logical ones, indexing and item assignment)
  against the JAX ``Tensor``'s on the same numpy inputs: f32 within 1e-6
  relative and 1e-6 absolute, integers and booleans exact.
- Every installed method against its function, bit for bit, on each case
  of ``test_torch_toplevel.py``'s tables whose op is a method; the methods
  whose names clash with torch's (``size``, ``reshape``, ``transpose``,
  ``split``, ``flatten``, ``max``, ``sort``, ``sum``, ...) against the JAX
  ``Tensor``'s methods; none of them is installed on ``torch.Tensor``.
- ``isinstance`` holds for every torch tensor; torch ops on a ``Tensor``
  return plain tensors; ``TrainStep`` takes ``Tensor`` inputs and returns a
  ``Tensor`` loss.
- Each of ``bench.py``'s five arms' models forward (train and eval mode)
  on a ``paddle.Tensor`` input and on a plain tensor: bit for bit equal.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch import device as device_mod

import test_torch_toplevel as tables


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(device_mod, "_chosen", None)
    T.set_device("cpu")
    yield


def _pair(a):
    return P.to_tensor(a), T.to_tensor(a)


def _close(got, want):
    tables._compare(tables._host(got, False), tables._host(want, True),
                    None, "tensor")


# ------------------------------------------------------------ properties
def test_properties_match_jax():
    rs = np.random.RandomState(0)
    a = rs.uniform(-2, 2, (3, 4)).astype(np.float32)
    j, t = _pair(a)
    assert type(t) is T.Tensor
    assert t.shape == j.shape == [3, 4] and isinstance(t.shape, list)
    assert t.size == j.size == 12
    assert t.ndim == j.ndim == 2 and t.dim() == 2 and t.rank() == 2
    assert t.dtype is T.float32 and j.dtype.name == "float32"
    assert t.place == "cpu"
    assert t.stop_gradient and j.stop_gradient
    _close(t.T, j.T)
    np.testing.assert_array_equal(t.numpy(), j.numpy())
    assert t.numpy().dtype == np.float32
    assert t[1, 2].item() == j[1, 2].item()
    assert t.item(5) == j.item(5)
    assert t.tolist() == j.tolist()
    _close(t.astype("int32"), j.astype("int32"))
    _close(t.cast(T.float16), j.cast("float16"))
    assert t.element_size() == 4
    assert t.is_floating_point() and not t.is_integer()
    assert T.to_tensor(np.arange(3)).is_integer()
    _close(t.numel(), j.numel())
    assert len(t) == len(j) == 3
    assert [r.tolist() for r in t] == [r.tolist() for r in j]
    assert all(type(r) is T.Tensor for r in t)
    assert "Tensor(shape=[3, 4], dtype=float32" in repr(t)
    np.testing.assert_array_equal(np.asarray(t), a)
    # stop_gradient is the inverse of requires_grad
    g = T.to_tensor(a, stop_gradient=False)
    assert g.requires_grad and not g.stop_gradient and g.is_leaf
    g.stop_gradient = True
    assert not g.requires_grad
    # bf16 comes to the host as float32 values, exactly
    b = T.to_tensor(a, dtype="bfloat16")
    np.testing.assert_array_equal(
        b.numpy(), b.as_subclass(torch.Tensor).float().numpy())
    assert b.numpy().dtype == np.float32
    # detach, clone, to, cpu keep the type
    for out in (t.detach(), t.clone(), t.to("cpu"), t.to("float64"),
                t.cpu()):
        assert type(out) is T.Tensor
    assert t.to("float64").dtype is torch.float64
    # a copy: the tensor does not share the numpy array's memory
    src = np.zeros(3, np.float32)
    c = T.to_tensor(src)
    src[0] = 1
    assert c[0].item() == 0


def test_copy_and_pickle_keep_the_type_and_values():
    import copy
    import pickle

    t = T.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3),
                    stop_gradient=False)
    for out in (copy.deepcopy(t), pickle.loads(pickle.dumps(t))):
        assert type(out) is T.Tensor and out.shape == [2, 3]
        assert not out.stop_gradient and out.data_ptr() != t.data_ptr()
        assert torch.equal(out.as_subclass(torch.Tensor),
                           t.as_subclass(torch.Tensor))


def test_tensor_constructor_matches_jax():
    a = np.arange(6, dtype=np.int64).reshape(2, 3)
    j = P.Tensor(a, stop_gradient=True)
    t = T.Tensor(a, stop_gradient=True)
    _close(t, j)
    t2 = T.Tensor(t)
    assert t2.data_ptr() != t.data_ptr()
    t3 = T.Tensor([1.5, 2.5], dtype="float64", stop_gradient=False)
    assert t3.dtype is torch.float64 and t3.requires_grad


def test_set_value_grad_and_clear_grad():
    t = T.to_tensor(np.ones((2, 2), np.float32), stop_gradient=False)
    (t * 3).sum().backward()
    assert type(t.grad) is T.Tensor
    np.testing.assert_array_equal(t.grad.numpy(), np.full((2, 2), 3.0))
    t.clear_grad()
    assert t.grad is None
    t.set_value(np.full((2, 2), 5.0))
    assert t.numpy().tolist() == [[5.0, 5.0], [5.0, 5.0]]


# ------------------------------------------------------------ operators
_OPS = [
    ("add", lambda x, y: x + y), ("radd", lambda x, y: 2.0 + x),
    ("sub", lambda x, y: x - y), ("rsub", lambda x, y: 1.5 - x),
    ("mul", lambda x, y: x * y), ("rmul", lambda x, y: 3 * x),
    ("truediv", lambda x, y: x / y), ("rtruediv", lambda x, y: 2.0 / y),
    ("floordiv", lambda x, y: x // y), ("mod", lambda x, y: x % y),
    ("pow", lambda x, y: abs(x) ** y), ("rpow", lambda x, y: 2.0 ** x),
    ("matmul", lambda x, y: x @ y.T), ("neg", lambda x, y: -x),
    ("abs", lambda x, y: abs(x)), ("eq", lambda x, y: x == y),
    ("ne", lambda x, y: x != y), ("lt", lambda x, y: x < y),
    ("le", lambda x, y: x <= y), ("gt", lambda x, y: x > y),
    ("ge", lambda x, y: x >= y), ("eq_scalar", lambda x, y: x == 0.5),
    ("getitem", lambda x, y: x[1:, ::2]), ("getitem_int", lambda x, y: x[2]),
    ("getitem_mask", lambda x, y: x[x > 0]),
]


@pytest.mark.parametrize("case", _OPS, ids=lambda c: c[0])
def test_float_operators_match_jax(case):
    _, op = case
    rs = np.random.RandomState(1)
    a = rs.uniform(-2, 2, (3, 4)).astype(np.float32)
    b = (rs.uniform(0.5, 2, (3, 4)) * rs.choice([-1, 1], (3, 4))).astype(
        np.float32)
    ja, ta = _pair(a)
    jb, tb = _pair(b)
    got = op(ta, tb)
    assert type(got) is T.Tensor
    _close(got, op(ja, jb))


_BITWISE = {"and": lambda x, y: x & y, "or": lambda x, y: x | y,
            "xor": lambda x, y: x ^ y, "invert": lambda x, y: ~x}


# JAX's ~ on an int tensor is logical_not (a bool result), the port's and
# torch's a bitwise not: that one pair is left out
@pytest.mark.parametrize("op,kind", [(op, kind) for op in _BITWISE
                                     for kind in ("bool", "int")
                                     if (op, kind) != ("invert", "int")])
def test_bitwise_operators_match_jax(op, kind):
    rs = np.random.RandomState(2)
    if kind == "bool":
        a, b = rs.rand(3, 4) > 0.5, rs.rand(3, 4) > 0.5
    else:
        a, b = rs.randint(0, 8, (3, 4)), rs.randint(0, 8, (3, 4))
    (ja, ta), (jb, tb) = _pair(a), _pair(b)
    _close(_BITWISE[op](ta, tb), _BITWISE[op](ja, jb))


def test_setitem_matches_jax():
    a = np.random.RandomState(3).uniform(-1, 1, (4, 3)).astype(np.float32)
    j, t = _pair(a)
    j[1] = 7.0
    t[1] = 7.0
    j[2:, 0] = P.to_tensor(np.array([1.0, 2.0], np.float32))
    t[2:, 0] = T.to_tensor(np.array([1.0, 2.0], np.float32))
    t[T.to_tensor(np.array([0]))] = 0.5
    j[P.to_tensor(np.array([0]))] = 0.5
    _close(t, j)


# ------------------------------------------------------------ methods
def _installed():
    from paddle_tpu_torch.core import tensor_methods

    # an op whose name the class defines itself (``cast``, ``set_value``)
    # keeps the class's method, as in the JAX package
    return {name for module in (T.ops.math, T.ops.manipulation,
                                T.ops.logic, T.ops.search, T.ops.stat,
                                T.ops.creation, T.ops.random)
            for name in module.__all__
            if tensor_methods._patchable(name, getattr(module, name))
            and getattr(T.Tensor.__dict__.get(name), "__wrapped__",
                        None) is getattr(module, name)}


def test_methods_are_installed_on_tensor_only():
    names = _installed()
    assert len(names) > 250
    for name in names:
        assert name in T.Tensor.__dict__, name
    for name in ("builtins_sum", "scatter_nd_add", "logsumexp_", "fill_"):
        if name in names:
            assert getattr(torch.Tensor, name, None) is not \
                T.Tensor.__dict__[name]
    assert not hasattr(torch.Tensor, "scatter_nd_add")
    assert not hasattr(torch.Tensor, "stanh")
    assert torch.Tensor.size is not T.Tensor.__dict__["size"]
    # the JAX skip list: constructors are not methods
    for name in ("zeros", "arange", "rand", "assign", "broadcast_shape"):
        assert name not in T.Tensor.__dict__


def _method_cases():
    out = []
    names = _installed()
    for table in (tables.CREATION, tables.MATH, tables.MANIPULATION,
                  tables.LOGIC, tables.SEARCH, tables.STAT):
        for case in table:
            # a method needs a tensor to be called on
            first = case[1](np.random.RandomState(0))[0]
            if case[0] in names and isinstance(first, np.ndarray):
                out.append(case)
    return out


@pytest.mark.parametrize("case", _method_cases(), ids=lambda c: c[0])
def test_each_method_is_its_function(case):
    name, make, kwargs, _ = case
    first, *rest = make(np.random.RandomState(0))
    rest_a = tables._args(rest, T)
    rest_b = tables._args(rest, T)
    x, y = T.to_tensor(first), T.to_tensor(first)
    got = getattr(x, name)(*rest_a, **kwargs)
    want = getattr(T, name, None) or getattr(T.tensor, name)
    want = want(y, *rest_b, **kwargs)
    tables._compare(tables._host(got, False), tables._host(want, False),
                    (0.0, 0.0), name)
    for out in (got if isinstance(got, (list, tuple)) else [got]):
        if isinstance(out, torch.Tensor):
            assert type(out) is T.Tensor, name


_CLASHES = [
    ("size", lambda t: t.size),
    ("shape", lambda t: t.shape),
    ("reshape", lambda t: t.reshape([4, 3])),
    ("transpose", lambda t: t.transpose([1, 0])),
    ("split", lambda t: t.split(2, axis=1)),
    ("split_sections", lambda t: t.split([1, 2], axis=0)),
    ("flatten", lambda t: t.flatten()),
    ("max", lambda t: t.max(axis=1)),
    ("min", lambda t: t.min(axis=0, keepdim=True)),
    ("sum", lambda t: t.sum(axis=1)),
    ("mean", lambda t: t.mean(axis=[0, 1])),
    ("sort", lambda t: t.sort(axis=1)),
    ("argsort", lambda t: t.argsort(axis=0, stable=True)),
    ("expand", lambda t: t[:1].expand([2, 4])),
    ("gather", lambda t: t.gather(P.to_tensor(np.array([2, 0])) if isinstance(
        t, P.Tensor) else T.to_tensor(np.array([2, 0])))),
    ("index_select", lambda t: t.index_select(
        (P if isinstance(t, P.Tensor) else T).to_tensor(np.array([1, 3])),
        axis=1)),
    ("squeeze", lambda t: t[:1].squeeze(axis=0)),
    ("unsqueeze", lambda t: t.unsqueeze(axis=[0, 2])),
    ("topk", lambda t: t.topk(2)),
    ("chunk", lambda t: t.chunk(2, axis=1)),
    ("flip", lambda t: t.flip([0])),
    ("roll", lambda t: t.roll(1, axis=1)),
    ("cumsum", lambda t: t.cumsum(axis=0)),
    ("prod", lambda t: t.prod(axis=1)),
    ("std", lambda t: t.std(axis=1)),
    ("all", lambda t: (t > 0).all(axis=1)),
    ("tile", lambda t: t.tile([2, 1])),
    ("repeat_interleave", lambda t: t.repeat_interleave(2, axis=0)),
    ("unbind", lambda t: t.unbind(axis=1)),
    ("matmul", lambda t: t.matmul(t, transpose_y=True)),
    ("view", lambda t: t.view([6, 2])),
    ("numel", lambda t: t.numel()),
    ("clip", lambda t: t.clip(-0.5, 0.5)),
    ("pow", lambda t: t.abs().pow(2.0)),
]


@pytest.mark.parametrize("case", _CLASHES, ids=lambda c: c[0])
def test_clashing_methods_take_paddles_meaning(case):
    _, fn = case
    a = np.random.RandomState(4).permutation(12).reshape(3, 4).astype(
        np.float32) - 6
    j, t = _pair(a)
    _close(fn(t), fn(j))


# ------------------------------------------------------------ torch interop
def test_torch_ops_on_a_tensor_return_plain_tensors():
    t = T.to_tensor(np.ones((2, 3), np.float32))
    assert isinstance(torch.zeros(1), T.Tensor)
    assert isinstance(torch.nn.Parameter(torch.zeros(1)), T.Tensor)
    for out in (torch.relu(t), t.double(), torch.nn.functional.linear(
            t, torch.ones(4, 3)), t.permute(1, 0), t.as_subclass(
                torch.Tensor) + 1):
        assert type(out) is torch.Tensor
    assert type(T.add(t, t)) is T.Tensor
    # the op modules keep plain tensors plain
    from paddle_tpu_torch.ops import math
    plain = torch.ones(2)
    assert type(math.add(plain, plain)) is torch.Tensor
    assert type(math.add(t, t)) is torch.Tensor


def test_train_step_takes_tensors_and_returns_one():
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import SGD

    lin = torch.nn.Linear(3, 1)
    opt = SGD(learning_rate=0.1, parameters=lin.parameters(), device="cpu")
    step = TrainStep(model=lin, optimizer=opt, device="cpu",
                     loss_fn=lambda x: lin(x).pow(2).mean())
    x = T.to_tensor(np.ones((4, 3), np.float32))
    loss = step(x)
    assert type(loss) is T.Tensor and loss.stop_gradient
    assert np.isfinite(loss.numpy()) and loss.numpy().shape == ()
    assert type(step(x.as_subclass(torch.Tensor))) is T.Tensor


# ------------------------------------------------------------ the arms' models
def _arm_models():
    from paddle_tpu_torch.models import bert, gpt, llama
    from paddle_tpu_torch.vision.models import pp_liteseg, resnet18

    rs = np.random.RandomState(0)
    gen = torch.Generator().manual_seed
    ids = rs.randint(0, 500, (4, 128)).astype(np.int64)
    yield ("gpt", gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu",
                                     generator=gen(0)), ids)
    yield ("llama", llama.LlamaForCausalLM(llama.llama_tiny(), device="cpu",
                                           generator=gen(0)), ids)
    yield ("bert", bert.BertForSequenceClassification(
        bert.bert_tiny(), num_classes=2, device="cpu", generator=gen(0)),
        ids[:, :32])
    yield ("resnet", resnet18(num_classes=10, device="cpu", generator=gen(0)),
           rs.randn(2, 3, 32, 32).astype(np.float32))
    yield ("liteseg", pp_liteseg(num_classes=4, base=16, device="cpu",
                                 generator=gen(0)),
           rs.randn(2, 3, 64, 64).astype(np.float32))


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("arm", ["gpt", "llama", "bert", "resnet", "liteseg"])
def test_arm_models_forward_on_a_tensor_as_on_a_plain_one(arm, mode):
    from paddle_tpu_torch.jit.api import model_generators

    name, model, batch = next(m for m in _arm_models() if m[0] == arm)
    model.train(mode == "train")
    outs = []
    for x in (T.to_tensor(batch), torch.from_numpy(batch)):
        for g in model_generators(model):
            g.manual_seed(0)
        out = model(x)
        outs.append(out[0] if isinstance(out, tuple) else out)
    a, b = outs
    assert type(b) is torch.Tensor
    assert torch.equal(a.as_subclass(torch.Tensor), b), name

"""``nn.Layer``, ``Parameter`` and ``ParamAttr`` of the port against the
JAX package's (``tests/test_nn_layers.py``'s container, hook and registry
cases, and more): the API, hook order and replacement, ``__setattr__``'s
re-wrapping, ``state_dict`` keys, ``set_state_dict``'s ``(missing,
unexpected)`` and its raise, ``create_parameter`` with every ``ParamAttr``
field, and every layer class the port's ``nn`` exports (and every model
class) being a ``Layer``. Values are compared exactly where no arithmetic
differs (constants, copies) and within 1e-6 otherwise.
"""
import copy
import inspect
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn as jnn
import paddle_tpu_torch as T
from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch import nn
from paddle_tpu_torch.models import bert, gpt, llama
from paddle_tpu_torch.models.gpt import jax_state_dict, load_jax_state
from paddle_tpu_torch.vision.models import resnet, segdet, small


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """``set_device("cpu")`` for each test; the default comes back after."""
    monkeypatch.setattr(device_mod, "_chosen", None)
    T.set_device("cpu")
    yield


def _net(pkg):
    """A user-written layer in ``pkg``: ``create_parameter``, a sublayer,
    a persistable and a non-persistable buffer."""

    class Net(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.scale = self.create_parameter(
                [3], default_initializer=pkg.nn.initializer.Constant(2.0))
            self.fc = pkg.nn.Linear(3, 2)
            self.register_buffer("count",
                                 pkg.to_tensor(np.zeros(1, np.float32)))
            self.register_buffer("table",
                                 pkg.to_tensor(np.ones(3, np.float32)),
                                 persistable=False)

        def forward(self, x):
            return self.fc(x * self.scale + self.table)

    return Net()


def _pair():
    P.seed(0)
    jnet = _net(P)
    net = _net(T)
    state = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    return jnet, load_jax_state(net, state)


def test_layer_registers_as_jax():
    jnet, net = _pair()
    assert list(net.state_dict()) == list(jnet.state_dict()) == [
        "scale", "fc.weight", "fc.bias", "count"]
    assert [n for n, _ in net.named_parameters()] == [
        n for n, _ in jnet.named_parameters()]
    assert isinstance(net.parameters(), list) and len(net.parameters()) == 3
    assert len(net.parameters(include_sublayers=False)) == 1
    assert [n for n, _ in net.named_buffers()] == ["count", "table"]
    assert [n for n, _ in net.named_sublayers()] == ["fc"]
    assert net.sublayers(include_self=True)[0] is net
    assert all(type(p) is T.Parameter for p in net.parameters())
    assert isinstance(net.scale, T.Tensor) and net.scale.is_parameter
    assert net.full_name() == jnet.full_name() == "net"
    x = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    got = net(torch.from_numpy(x)).detach().numpy()
    want = np.asarray(jnet(P.to_tensor(x)).numpy())
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_state_dict_round_trip_and_refusals_as_jax():
    jnet, net = _pair()
    state = {k: v.detach().clone() for k, v in net.state_dict().items()}
    state["extra"] = torch.zeros(1)
    del state["count"]
    missing, unexpected = net.set_state_dict(state)
    jstate = {k: v for k, v in jnet.state_dict().items()}
    jstate["extra"] = P.zeros([1])
    del jstate["count"]
    jmissing, junexpected = jnet.set_state_dict(jstate)
    assert (missing, unexpected) == (jmissing, junexpected) == (
        ["count"], ["extra"])
    assert type(net).load_dict is type(net).set_state_dict
    with pytest.raises(ValueError, match="shape mismatch"):
        net.set_state_dict({"scale": torch.zeros(4)})
    with pytest.raises(Exception):
        jnet.set_state_dict({"scale": P.zeros([4])})
    net.set_state_dict({"scale": np.full(3, 5.0, np.float32)})
    assert torch.equal(net.scale.detach(), torch.full((3,), 5.0))
    # torch's own keywords still work through the override
    assert list(net.state_dict(prefix="m.")) == [
        "m.scale", "m.fc.weight", "m.fc.bias", "m.count"]
    assert list(net.state_dict(structured_name_prefix="m")) == [
        "m.scale", "m.fc.weight", "m.fc.bias", "m.count"]
    assert list(net.state_dict(include_sublayers=False)) == [
        "scale", "count"]


def test_hooks_order_replacement_and_removal_as_jax():
    def run(pkg, net):
        calls = []
        x = pkg.to_tensor(np.ones((1, 3), np.float32))
        h1 = net.register_forward_pre_hook(
            lambda layer, inp: calls.append("pre1"))
        h2 = net.register_forward_pre_hook(
            lambda layer, inp: (calls.append("pre2"), inp[0] * 0)[1])
        h3 = net.register_forward_post_hook(
            lambda layer, inp, out: calls.append(
                ("post", float(np.asarray(inp[0].numpy()).sum()))))
        h4 = net.register_forward_post_hook(
            lambda layer, inp, out: out * 0 + 7)
        out = net(x)
        first = (list(calls), np.asarray(out.detach().numpy()
                                         if isinstance(out, torch.Tensor)
                                         else out.numpy()))
        for h in (h1, h2, h3, h4):
            h.remove()
        calls.clear()
        net(x)
        return first, calls

    jnet, net = _pair()
    (jcalls, jout), jafter = run(P, jnet)
    (calls, out), after = run(T, net)
    assert calls == jcalls == ["pre1", "pre2", ("post", 0.0)]
    assert np.array_equal(out, jout) and float(out.max()) == 7.0
    assert after == jafter == []


def test_setattr_rewraps_a_tensor_as_a_parameter_as_jax():
    lin = nn.Linear(2, 2)
    jlin = jnn.Linear(2, 2)
    lin.weight = torch.ones(2, 2)
    jlin.weight = P.ones([2, 2])
    assert type(lin.weight) is T.Parameter and lin.weight.trainable
    assert any(p is lin.weight for p in lin.parameters())
    assert any(p is jlin.weight for p in jlin.parameters())
    assert torch.equal(lin.weight.detach(), torch.ones(2, 2))
    lin.bias = T.to_tensor(np.zeros(2, np.float32))
    assert type(lin.bias) is T.Parameter
    with pytest.raises(TypeError):
        lin.weight = "nope"
    with pytest.raises(TypeError):
        jlin.weight = "nope"
    lin.bias = None
    assert lin.bias is None and len(lin.parameters()) == 1
    # a torch nn.Parameter becomes one too
    lin.extra = torch.nn.Parameter(torch.zeros(1))
    assert type(lin.extra) is T.Parameter
    p = lin.add_parameter("w2", torch.ones(3))
    assert type(p) is T.Parameter and lin.w2 is p
    sub = lin.add_sublayer(5, nn.ReLU())
    assert lin._modules["5"] is sub


def test_create_parameter_takes_every_param_attr_field():
    def make(pkg):
        class L(pkg.nn.Layer):
            def __init__(self):
                super().__init__()
                attr = pkg.nn.ParamAttr(
                    name="w_named",
                    initializer=pkg.nn.initializer.Constant(0.5),
                    learning_rate=0.1, regularizer="reg", trainable=False,
                    need_clip=False)
                self.w = self.create_parameter([2, 3], attr=attr)
                self.b = self.create_parameter([3], is_bias=True)
                self.x = self.create_parameter([4, 5])
                self.none = self.create_parameter([1], attr=False)
        return L()

    layer, jlayer = make(T), make(P)
    for w in (layer.w, jlayer.w):
        assert w.trainable is False and w.stop_gradient is True
        assert w.optimize_attr["learning_rate"] == 0.1
        assert w.regularizer == "reg"
        assert np.array_equal(np.asarray(w.numpy()), np.full((2, 3), 0.5))
    assert layer.w.param_name == jlayer.w.name == "w_named"
    assert layer.w.need_clip is False
    assert layer.none is None and jlayer.none is None
    assert torch.equal(layer.b.detach(), torch.zeros(3))  # Constant(0)
    std = np.sqrt(2.0 / 9.0)  # XavierNormal on [4, 5]
    assert abs(float(layer.x.detach().std()) - std) < 0.35 * std
    assert layer.w.device.type == "cpu"
    # attr=str names it; an initializer stands for a ParamAttr
    lin = nn.Linear(3, 4, weight_attr="lin_w",
                    bias_attr=nn.initializer.Constant(1.0))
    assert lin.weight.param_name == "lin_w"
    assert torch.equal(lin.bias.detach(), torch.ones(4))
    assert nn.Linear(3, 4, bias_attr=False).bias is None


def test_global_initializer_and_defaults_follow_jax_precedence():
    init = nn.initializer
    try:
        init.set_global_initializer(init.Constant(3.0), init.Constant(4.0))
        P.nn.initializer.set_global_initializer(
            P.nn.initializer.Constant(3.0), P.nn.initializer.Constant(4.0))
        lin, jlin = nn.Linear(2, 2), jnn.Linear(2, 2)
        # the Linear names its weight's default, which the global one does
        # not override; the bias has none, so the global one fills it
        assert torch.equal(lin.bias.detach(), torch.full((2,), 4.0))
        assert np.array_equal(jlin.bias.numpy(), np.full(2, 4.0))
        assert float(lin.weight.detach().abs().max()) != 3.0
    finally:
        init.set_global_initializer(None, None)
        P.nn.initializer.set_global_initializer(None, None)


def test_parameter_survives_copies_moves_and_casts():
    lin = nn.Linear(3, 3)
    w = lin.weight
    w.optimize_attr["learning_rate"] = 0.25
    w.need_clip = False
    c = copy.deepcopy(lin)
    assert type(c.weight) is T.Parameter and c.weight is not w
    assert c.weight.optimize_attr == {"learning_rate": 0.25}
    assert c.weight.transposed and not c.weight.need_clip
    assert torch.equal(c.weight, w)
    r = pickle.loads(pickle.dumps(w))
    assert type(r) is T.Parameter and r.optimize_attr["learning_rate"] == 0.25
    lin.to(dtype="bfloat16")
    assert type(lin.weight) is T.Parameter and lin.weight.dtype == \
        torch.bfloat16 and lin.weight.optimize_attr["learning_rate"] == 0.25
    lin.astype("float32").float16()
    assert lin.weight.dtype == torch.float16
    lin.to("cpu")
    lin.to(device="cpu", dtype=T.float32)
    assert lin.weight.dtype == torch.float32
    lin.to_empty(device="cpu")
    assert type(lin.weight) is T.Parameter
    w = lin.weight
    w.stop_gradient = True
    assert not w.requires_grad and not w.trainable
    w.trainable = True
    assert w.requires_grad
    lin(torch.ones(1, 3)).sum().backward()
    assert w.grad is not None
    lin.clear_gradients()
    assert w.grad is None
    assert isinstance(w, T.Tensor) and isinstance(w, torch.nn.Parameter)


def test_dropout_layers_hold_the_shared_generator_from_construction():
    """A layer that draws dropout without a generator holds the
    process-wide one from its construction (before any call, so a snapshot
    or a captured step finds it); a copy shares it, as every JAX copy
    draws from the one global key; one given, or p = 0, is kept as is."""
    from paddle_tpu_torch.jit.api import model_generators

    gen = T.base.global_state.dropout_generator("cpu")
    own = torch.Generator().manual_seed(1)
    seq = nn.Sequential(nn.Linear(4, 4), nn.Dropout(0.1), nn.RReLU(),
                        nn.MultiHeadAttention(4, 2, dropout=0.1),
                        nn.Dropout(0.5, generator=own), nn.Dropout(0.0))
    assert [seq[i].generator for i in (1, 2, 3)] == [gen] * 3
    assert seq[4].generator is own and seq[5].generator is None
    assert model_generators(seq) == [gen, own]
    c = copy.deepcopy(seq)
    assert all(c[i].generator is seq[i].generator for i in range(1, 6))
    assert c[0].weight is not seq[0].weight
    assert torch.equal(c[0].weight, seq[0].weight)
    assert c.to("cpu")[1].generator is gen


def test_containers_as_jax():
    net = nn.Sequential(nn.Linear(2, 4), nn.ReLU(), nn.Linear(4, 1))
    assert len(net) == 3 and len(net.parameters()) == 4
    named = nn.Sequential(("a", nn.Linear(2, 2)), ("b", nn.ReLU()))
    assert list(named.state_dict()) == ["a.weight", "a.bias"]
    ll = nn.LayerList([nn.Linear(2, 2) for _ in range(3)])
    ll.append(nn.Linear(2, 2))
    assert len(ll) == 4 and len(list(ll)) == 4
    pl = nn.ParameterList([torch.zeros(2), T.Parameter(torch.ones(3))])
    pl.append(torch.nn.Parameter(torch.ones(1)))
    assert len(pl) == 3 and all(type(p) is T.Parameter for p in pl)
    assert list(pl.state_dict()) == ["0", "1", "2"]
    jpl = jnn.ParameterList([P.zeros([2]), P.ones([3])])
    assert list(jpl.state_dict()) == ["0", "1"]
    ld = nn.LayerDict({"x": nn.Linear(2, 2)})
    ld["y"] = nn.ReLU()
    ld.update([("z", nn.Tanh())])
    assert list(ld.keys()) == ["x", "y", "z"] and "y" in ld
    assert isinstance(ld.pop("y"), nn.ReLU) and len(ld) == 2
    jld = jnn.LayerDict({"x": jnn.Linear(2, 2)})
    assert list(ld.state_dict()) == list(jld.state_dict())
    for container in (ll, pl, ld):
        with pytest.raises(NotImplementedError):
            container(torch.ones(1))
    net.eval()
    assert all(not m.training for m in net.sublayers(include_self=True))
    net.train()
    assert net[1].training


def test_jax_state_dict_round_trips_a_user_layer_tree():
    """``jax_state_dict``/``load_jax_state`` over a user ``Layer`` with a
    ``LayerList`` of copies and a non-persistable buffer (left out), both
    packages building the same tree."""
    def build(pkg):
        class Tree(pkg.nn.Layer):
            def __init__(self):
                super().__init__()
                block = pkg.nn.Linear(4, 4)
                self.blocks = pkg.nn.LayerList(
                    [block] + [copy.deepcopy(block) for _ in range(2)])
                self.norm = pkg.nn.LayerNorm(4)
                self.register_buffer(
                    "cache", pkg.to_tensor(np.zeros(4, np.float32)),
                    persistable=False)

            def forward(self, x):
                for b in self.blocks:
                    x = b(x)
                return self.norm(x)
        return Tree()

    P.seed(3)
    jtree, tree = build(P), build(T)
    state = {k: np.asarray(v.numpy()) for k, v in jtree.state_dict().items()}
    assert "cache" not in state and len(state) == 8
    load_jax_state(tree, state)
    back = jax_state_dict(tree)
    assert list(back) == list(state)
    for k, v in back.items():
        assert np.array_equal(v.numpy(), state[k]), k
    x = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    np.testing.assert_allclose(tree(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jtree(P.to_tensor(x)).numpy()),
                               atol=1e-6)


def _exported_layer_classes():
    out = []
    for name in nn.__all__:
        obj = getattr(nn, name)
        if inspect.isclass(obj) and issubclass(obj, torch.nn.Module):
            out.append(name)
    return out


@pytest.mark.parametrize("name", _exported_layer_classes())
def test_every_exported_layer_class_is_a_layer(name):
    cls = getattr(nn, name)
    assert issubclass(cls, nn.Layer), name
    jcls = getattr(jnn, name, None)
    if jcls is not None:
        assert issubclass(jcls, jnn.Layer)


MODEL_CLASSES = [obj for module in (gpt, llama, bert, resnet, segdet, small)
                 for obj in vars(module).values()
                 if inspect.isclass(obj) and issubclass(obj, torch.nn.Module)
                 and obj.__module__ == module.__name__]


@pytest.mark.parametrize("cls", MODEL_CLASSES, ids=lambda c: c.__name__)
def test_every_model_class_is_a_layer(cls):
    assert issubclass(cls, nn.Layer)


def test_model_parameters_are_parameters():
    model = gpt.GPTForCausalLM(gpt.gpt_tiny(), device="cpu",
                               generator=torch.Generator().manual_seed(0))
    assert isinstance(model, nn.Layer)
    assert all(type(p) is T.Parameter for p in model.parameters())
    assert all(p.param_name == n for n, p in model.named_parameters())
    net = resnet.resnet18(num_classes=10, device="cpu")
    assert all(type(p) is T.Parameter for p in net.parameters())
    assert not any(hasattr(p, "init_fn") and p.init_fn is None
                   for p in net.parameters() if p.ndim == 4)

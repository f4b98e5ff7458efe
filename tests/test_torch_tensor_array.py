"""``TensorArray``, ``SelectedRows`` and ``StringTensor`` of the port
(``core/tensor_array.py``) against the JAX package's containers."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as paddle
from paddle_tpu_torch import device as device_mod


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(device_mod, "_chosen", None)
    paddle.set_device("cpu")


def test_tensor_array_matches_jax():
    rs = np.random.RandomState(0)
    items = [rs.randn(2, 3).astype(np.float32) for _ in range(4)]
    ta, ja = paddle.TensorArray(items[:2]), jp.TensorArray(items[:2])
    for v in items[2:]:
        ta.append(v)
        ja.write(v)
    assert len(ta) == len(ja) == 4
    for axis in (0, 1):
        np.testing.assert_array_equal(ta.stack(axis).numpy(),
                                      np.asarray(ja.stack(axis).numpy()))
        np.testing.assert_array_equal(ta.concat(axis).numpy(),
                                      np.asarray(ja.concat(axis).numpy()))
    np.testing.assert_array_equal(ta.read(1).numpy(), items[1])
    np.testing.assert_array_equal(ta.pop().numpy(),
                                  np.asarray(ja.pop().numpy()))
    assert len(ta) == 3 and isinstance(ta[0], paddle.Tensor)


def test_selected_rows_match_jax():
    rows = np.array([4, 1, 4, 0, 1], np.int64)
    value = np.random.RandomState(1).randn(5, 3).astype(np.float32)
    sr, jr = paddle.SelectedRows(rows, value, 6), jp.SelectedRows(rows, value,
                                                                   6)
    np.testing.assert_allclose(sr.to_dense().numpy(),
                               np.asarray(jr.to_dense().numpy()), rtol=1e-6,
                               atol=1e-6)
    sm, jm = sr.merge(), jr.merge()
    np.testing.assert_array_equal(sm.rows.numpy(), np.asarray(jm.rows.numpy()))
    np.testing.assert_allclose(sm.value.numpy(), np.asarray(jm.value.numpy()),
                               rtol=1e-6, atol=1e-6)
    assert sm.height == jm.height == 6
    assert repr(sr) == repr(jr)


def test_string_tensor_matches_jax():
    data = [["a", "bc"], ["def", ""]]
    st, js = paddle.StringTensor(data, "s"), jp.StringTensor(data, "s")
    assert st.shape == js.shape == [2, 2]
    assert len(st) == len(js) == 2
    assert st[0, 1] == js[0, 1] == "bc"
    assert st[1].shape == js[1].shape == [2]
    assert (st.numpy() == js.numpy()).all()
    assert repr(st) == repr(js)

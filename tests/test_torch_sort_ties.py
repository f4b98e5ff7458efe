"""``argsort``'s tie order in the two packages.

Under ``stable=True`` both give ties in their input order, descending as
well as ascending, so they agree element for element. Under
``stable=False`` the order of ties is unspecified upstream, and the two
packages differ on it (``ROADMAP.md``, divergences kept on purpose: on
``[0, 1, 1, 0]`` descending JAX gives ``[2, 1, 3, 0]``, the port ``[1, 2,
0, 3]``); each is a valid descending order.
"""
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as paddle

ROWS = [[0, 1, 1, 0], [3, 3, 3, 1, 1, 2], [5, 5, 5, 5]]


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("row", ROWS)
def test_stable_argsort_agrees_with_jax(row, descending):
    x = np.asarray(row, np.float32)
    got = paddle.argsort(paddle.to_tensor(x, place="cpu"),
                         descending=descending, stable=True).numpy()
    want = jpaddle.argsort(jpaddle.to_tensor(x), descending=descending,
                           stable=True).numpy()
    np.testing.assert_array_equal(got, want)
    # ties in their input order
    order = sorted(range(len(row)), key=lambda i: -row[i] if descending
                   else row[i])
    np.testing.assert_array_equal(got, order)


def test_unstable_descending_ties_are_a_valid_order_in_both():
    x = np.asarray([0, 1, 1, 0], np.float32)
    for idx in (paddle.argsort(paddle.to_tensor(x, place="cpu"),
                               descending=True).numpy(),
                jpaddle.argsort(jpaddle.to_tensor(x),
                                descending=True).numpy()):
        assert sorted(idx.tolist()) == [0, 1, 2, 3]
        assert (np.diff(x[idx]) <= 0).all()

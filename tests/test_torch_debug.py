"""``jeicyboodsp_tpu_torch.utils.debug`` against the JAX package's
``utils/debug.py`` (tests/test_streaming.py::test_checked_guard): finite
trees pass, non-finite ones raise; 0/0 under ``nan_debug`` raises and names
the op; ``checked`` also flags an inf from finite inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jeicyboodsp_tpu.utils.debug import assert_all_finite as jax_assert_all_finite
from jeicyboodsp_tpu_torch.utils.debug import assert_all_finite, checked, nan_debug


@pytest.mark.parametrize("values", [[1.0, 2.0], [1.0, np.nan], [np.inf, 0.0]],
                         ids=["finite", "nan", "inf"])
def test_assert_all_finite_as_jax_s(values):
    def raises(fn, tree):
        try:
            fn(tree)
        except FloatingPointError:
            return True
        return False

    want = raises(jax_assert_all_finite, {"a": jnp.ones(3), "b": [jnp.asarray(values)]})
    got = raises(assert_all_finite, {"a": torch.ones(3), "b": [torch.tensor(values)]})
    assert got == want == (not np.isfinite(values).all())


def test_assert_all_finite_nested_and_non_float_leaves():
    assert_all_finite({"a": torch.ones(3), "b": [torch.arange(3), (torch.ones(2, 2), 5)]})
    with pytest.raises(FloatingPointError, match="states: non-finite values in leaf 2"):
        assert_all_finite([torch.ones(1), torch.arange(2), torch.tensor([np.nan])], "states")


def test_nan_debug_names_the_op():
    z = torch.zeros(4)
    with pytest.raises(FloatingPointError, match="aten.div"):
        with nan_debug():
            z / z
    with nan_debug():  # finite work passes, and the mode is gone after the block
        y = torch.ones(4) / 2 + torch.arange(4)
    assert torch.isnan(z / z).all() and y.tolist() == [0.5, 1.5, 2.5, 3.5]


def test_checked_flags_nan_and_new_inf():
    def div(a, b):
        return a / b

    with pytest.raises(FloatingPointError, match="inf from finite inputs.*aten.div"):
        checked(div)(torch.ones(3), torch.zeros(3))
    with pytest.raises(FloatingPointError, match="NaN.*aten.div"):
        checked(div)(torch.zeros(3), torch.zeros(3))
    # an inf carried in from the inputs is the caller's, as checkify's division check
    out = checked(div)(torch.tensor([np.inf, 1.0]), torch.ones(2))
    assert torch.isinf(out[0]) and out[1] == 1.0
    assert checked(div).__name__ == "div"

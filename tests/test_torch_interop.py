"""Parameter trees across the JAX/PyTorch boundary: bit-exact bf16 and f32
round trips, and the same names and shapes on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models.transformer import init_params as jax_init_params
from repro_torch.configs import reduced_config
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.models.params import tree_leaves
from repro_torch.models.transformer import init_params

ARCHS = ["qwen3-1.7b", "qwen2.5-14b", "llama3-405b"]


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Torch on two threads: the test workers share the machine's cores, and
    torch's default (one thread per core) in every worker slows the others,
    wall-clock assertions included; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_numpy_tree(arch, dtype=jnp.bfloat16):
    params = jax_init_params(jax_reduced_config(arch), jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a.astype(dtype)), params)


def _bits(a):
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_round_trip_is_bit_exact(arch, dtype):
    src = _jax_numpy_tree(arch, dtype)
    state = params_from_jax(src, "cpu")
    back = params_to_numpy(state)
    want = dict(tree_leaves(src))
    got = dict(tree_leaves(back))
    assert got.keys() == want.keys()
    for path, a in want.items():
        assert got[path].dtype == _bits(a).dtype, path
        np.testing.assert_array_equal(got[path], _bits(a), err_msg=str(path))
    torch_dtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    assert all(t.dtype == torch_dtype for _, t in tree_leaves(state))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_has_the_reference_names_and_shapes(arch):
    """A tree the port initialises itself is interchangeable with one that
    crosses over from JAX: same paths, shapes and dtypes."""
    crossed = params_from_jax(_jax_numpy_tree(arch), "cpu")
    own = init_params(reduced_config(arch), torch.Generator().manual_seed(0))
    a = {p: (tuple(t.shape), t.dtype) for p, t in tree_leaves(crossed)}
    b = {p: (tuple(t.shape), t.dtype) for p, t in tree_leaves(own)}
    assert a == b


def test_crossed_tensors_own_their_memory():
    """The port may update in place, so a crossed tensor must not alias the
    (read-only) array it came from."""
    src = np.arange(6, dtype=np.float32).reshape(2, 3)
    src.setflags(write=False)
    t = params_from_jax(src, "cpu")
    t.add_(1)
    assert src[0, 0] == 0 and float(t[0, 0]) == 1

"""The port's msgpack reader and writer (flax's format without flax)
held against the JAX package's flax-based ``load_pytree``/
``save_pytree``: bit-exact on the committed Burgers coarse model, a
round trip through the port, and flax reading what the port wrote."""

import numpy as np
import pytest

from pararealml_tpu.utils import checkpoint as jax_checkpoint
from pararealml_tpu_torch.utils import checkpoint
from tests.test_torch_cuda import QUAD_ASSET


def test_reads_the_committed_asset_as_flax_does():
    expected = jax_checkpoint.load_pytree(
        QUAD_ASSET, {name: 0 for name in checkpoint.load_pytree(QUAD_ASSET)}
    )
    actual = checkpoint.load_pytree(QUAD_ASSET)
    assert sorted(actual) == sorted(expected) == [
        "basis",
        "intercept",
        "mean",
        "quad_weights",
        "weights",
        "z_high",
        "z_low",
    ]
    assert actual["quad_weights"].shape == (882, 528)
    for name, value in expected.items():
        value = np.asarray(value)
        assert actual[name].dtype == value.dtype == np.float32
        assert actual[name].shape == value.shape
        assert actual[name].tobytes() == value.tobytes(), name
    # written back, the tree is the same bytes as the file
    with open(QUAD_ASSET, "rb") as f:
        assert checkpoint.encode(actual) == f.read()


def _tree():
    rng = np.random.default_rng(0)
    return {
        "weights": rng.standard_normal((70, 300)).astype(np.float32),
        "bias": rng.standard_normal(3),
        "scalar": np.asarray(2.5, np.float32),
        "nested": {"counts": np.arange(5, dtype=np.int64), "empty": {}},
        "layers": [np.ones((2, 2), np.float16), np.zeros(0, np.float32)],
    }


def _assert_trees_equal(actual, expected):
    if isinstance(expected, dict):
        assert sorted(actual) == sorted(expected)
        for key in expected:
            _assert_trees_equal(actual[key], expected[key])
    elif isinstance(expected, list):
        assert len(actual) == len(expected)
        for a, e in zip(actual, expected):
            _assert_trees_equal(a, e)
    else:
        actual = np.asarray(actual)
        assert actual.dtype == expected.dtype
        np.testing.assert_array_equal(actual, expected)


def test_save_load_round_trip(tmp_path):
    path = str(tmp_path / "tree.msgpack")
    tree = _tree()
    checkpoint.save_pytree(path, tree)
    _assert_trees_equal(checkpoint.load_pytree(path, tree), tree)
    # lists are stored as dictionaries keyed by their indices
    assert sorted(checkpoint.load_pytree(path)["layers"]) == ["0", "1"]
    # a template fixes the keys
    with pytest.raises(ValueError, match="keys"):
        checkpoint.load_pytree(path, {"weights": None})


def test_flax_reads_what_the_port_wrote(tmp_path):
    path = str(tmp_path / "tree.msgpack")
    tree = _tree()
    checkpoint.save_pytree(path, tree)
    flax_path = str(tmp_path / "flax.msgpack")
    jax_checkpoint.save_pytree(flax_path, tree)
    with open(path, "rb") as ours, open(flax_path, "rb") as flax:
        assert ours.read() == flax.read()
    _assert_trees_equal(jax_checkpoint.load_pytree(path, tree), tree)


def test_values_outside_the_subset_raise():
    with pytest.raises(TypeError, match="subset"):
        checkpoint.encode({"x": 1.5})
    with pytest.raises(ValueError, match="subset"):
        checkpoint.decode(b"\xca\x00\x00\x00\x00")  # a float32 scalar
    with pytest.raises(ValueError, match="ndarray"):
        checkpoint.decode(b"\xd4\x02\x00")  # an extension of type 2

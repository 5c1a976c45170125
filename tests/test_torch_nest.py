"""The port's nest helpers that the learn batcher reaches (cat, zip,
squeeze, unsqueeze) against the reference's, on the same numpy trees;
and on torch leaves, beside numpy ones, as a learn unroll holds them."""

import numpy as np
import pytest
import torch

from moolib_tpu.utils import nest as ref_nest
from moolib_tpu_torch.utils import nest as port_nest


def _tree(rng, lead):
    return {"obs": rng.standard_normal((*lead, 2)).astype(np.float32),
            "done": rng.random(lead) < 0.5,
            "core": (rng.integers(0, 9, (*lead, 3)).astype(np.int64),
                     [rng.standard_normal(lead).astype(np.float32)]),
            "empty": ()}


def _same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        a = np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("axis", [0, 1])
def test_cat_fields_equals_the_reference(axis):
    rng = np.random.default_rng(axis)
    trees = [_tree(rng, (3, 2)), _tree(rng, (3, 2)), _tree(rng, (3, 2))]
    _same(ref_nest.cat_fields(trees, axis=axis),
          port_nest.cat_fields(trees, axis=axis))


def test_cat_fields_of_torch_leaves_stays_torch():
    rng = np.random.default_rng(2)
    trees = [_tree(rng, (4,)) for _ in range(2)]
    mixed = [{**t, "core": tuple(
        torch.from_numpy(x) if isinstance(x, np.ndarray) else
        [torch.from_numpy(y) for y in x] for x in t["core"])}
        for t in trees]
    got = port_nest.cat_fields(mixed)
    assert isinstance(got["obs"], np.ndarray)
    assert isinstance(got["core"][0], torch.Tensor)
    _same(ref_nest.cat_fields(trees), got)
    with pytest.raises(ValueError):
        port_nest.cat_fields([])


@pytest.mark.parametrize("axis", [0, 2])
def test_squeeze_and_unsqueeze_equal_the_reference(axis):
    rng = np.random.default_rng(3)
    tree = _tree(rng, (2, 3))
    up_ref = ref_nest.unsqueeze_fields(tree, axis=axis)
    up_port = port_nest.unsqueeze_fields(tree, axis=axis)
    _same(up_ref, up_port)
    _same(ref_nest.squeeze_fields(up_ref, axis=axis),
          port_nest.squeeze_fields(up_port, axis=axis))
    t = port_nest.unsqueeze_fields({"x": torch.zeros(2, 3)}, axis=axis)
    assert isinstance(t["x"], torch.Tensor)
    assert port_nest.squeeze_fields(t, axis=axis)["x"].shape == (2, 3)


def test_zip_structures_equals_the_reference():
    rng = np.random.default_rng(4)
    a, b = _tree(rng, (2,)), _tree(rng, (2,))
    r, p = ref_nest.zip_structures(a, b), port_nest.zip_structures(a, b)
    assert isinstance(p["obs"], tuple) and len(p["obs"]) == 2
    for key in ("obs", "done"):
        for x, y in zip(r[key], p[key]):
            _same(x, y)

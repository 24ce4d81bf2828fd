"""``configs/shapes.py`` against the reference's ``repro/configs/shapes.py``:
``applicable`` and every input spec's shape and dtype for each (arch,
shape) in ``ARCHS`` x ``SHAPES``.

The port's specs are meta tensors where the reference's are
``jax.ShapeDtypeStruct``s.  Token inputs (``tokens``, ``targets``,
``token``, ``pos``) are int64 in the port, the index type its model takes,
where the reference's are int32; every other leaf has the reference's
dtype.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS, SHAPES as R_SHAPES
from repro.configs import applicable as r_applicable
from repro.configs import input_specs as r_input_specs
from repro_torch.configs import (ARCHS, SHAPES, ShapeSpec, applicable,
                                 input_specs)
from repro_torch.configs.shapes import SUBQUADRATIC, TOKEN_DTYPE

TOKEN_KEYS = ("tokens", "targets", "token", "pos")
CELLS = [(a, s) for a in sorted(ARCHS) for s in SHAPES]


def _leaves(tree, path=""):
    """(path, leaf) of a tree of dicts and lists, in key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def test_shapes_table_is_the_references():
    assert list(SHAPES) == list(R_SHAPES)
    for name, s in SHAPES.items():
        r = R_SHAPES[name]
        assert isinstance(s, ShapeSpec)
        assert (s.name, s.kind, s.seq, s.batch) == (r.name, r.kind, r.seq,
                                                    r.batch)
    assert SUBQUADRATIC == ("ssm", "hybrid")
    assert TOKEN_DTYPE is torch.int64


@pytest.mark.parametrize("arch,shape", CELLS)
def test_applicable_and_specs_match_reference(arch, shape):
    cfg, r_cfg = ARCHS[arch], R_ARCHS[arch]
    assert applicable(cfg, SHAPES[shape]) == r_applicable(r_cfg,
                                                          R_SHAPES[shape])
    got = dict(_leaves(input_specs(cfg, SHAPES[shape])))
    want = dict(_leaves(r_input_specs(r_cfg, R_SHAPES[shape])))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        ref = want[path]
        assert isinstance(leaf, torch.Tensor) and leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(ref.shape), path
        if path.split(".")[-1] in TOKEN_KEYS:
            assert ref.dtype == jnp.int32 and leaf.dtype is torch.int64
        else:
            assert str(leaf.dtype).split(".")[-1] == np.dtype(
                ref.dtype).name, path

"""The port's ``configs/shapes.py`` against ``repro``'s: the shape set,
and for every (arch x shape) cell of the 40 the same input keys, shapes
and dtypes (``repro``'s ``jax.ShapeDtypeStruct``\\ s against the port's
meta tensors, which allocate nothing) and the same ``cell_supported``
answer.  Exact."""

import dataclasses

import pytest
import torch

from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro_torch.configs import registry as treg
from repro_torch.configs import shapes as tshapes


def test_shape_set_equals_repro():
    assert list(tshapes.SHAPES) == list(jshapes.SHAPES)
    for name, spec in tshapes.SHAPES.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            jshapes.SHAPES[name])
    assert tshapes.SUBQUADRATIC == jshapes.SUBQUADRATIC


@pytest.mark.parametrize("shape", list(jshapes.SHAPES))
@pytest.mark.parametrize("arch", list(jreg.ARCH_IDS))
def test_input_specs_and_support_equal_repro(arch, shape):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    want = jshapes.input_specs(jcfg, jshapes.SHAPES[shape])
    got = tshapes.input_specs(tcfg, tshapes.SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k, spec in want.items():
        t = got[k]
        assert isinstance(t, torch.Tensor) and t.device.type == "meta"
        assert tuple(t.shape) == spec.shape, k
        assert str(t.dtype).removeprefix("torch.") == str(spec.dtype), k
    assert (tshapes.cell_supported(tcfg, shape)
            == jshapes.cell_supported(jcfg, shape))

"""The port's ``jax.eval_shape``: ``param_specs`` and ``cache_specs`` on
the ``meta`` device against ``repro.models.api``'s structs, leaf for leaf
(key path, shape, dtype), for every arch of the registry at SMOKE and
FULL size and every shape of its grid; ``get_shapes`` and ``list_cells``
against the JAX registry's."""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.configs import get_shapes as j_get_shapes
from repro.configs import get_smoke as j_get_smoke
from repro.configs import list_cells as j_list_cells
from repro.configs import shapes as j_shapes
from repro.models import api as j_api
from repro_torch.checkpoint import tree_flatten_with_paths
from repro_torch.configs import (
    ARCH_IDS, get_config, get_shapes, get_smoke, list_cells,
)
from repro_torch.configs import shapes
from repro_torch.models import cache_specs, param_specs

ARCHS = ARCH_IDS + ("llama2-7b-proxy",)
SIZES = {"smoke": (j_get_smoke, get_smoke), "full": (j_get_config, get_config)}


def _jax(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in kp), tuple(v.shape), np.dtype(v.dtype).name)
            for kp, v in flat]


def _port(tree):
    paths, leaves = tree_flatten_with_paths(tree)
    assert all(t.device.type == "meta" for t in leaves)
    return [(p, tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in zip(paths, leaves)]


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_eval_shape(arch, size):
    jcfg, tcfg = (f(arch) for f in SIZES[size])
    got = _port(param_specs(tcfg))
    assert got == _jax(j_api.param_specs(jcfg))
    assert got


def _shape(s):
    return shapes.ShapeConfig(**dataclasses.asdict(s))


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_eval_shape(arch, size):
    """Every shape of the arch's grid (the long_500k decode of the
    sub-quadratic families among them)."""
    jcfg, tcfg = (f(arch) for f in SIZES[size])
    for js in j_get_shapes(arch):
        got = _port(cache_specs(tcfg, _shape(js)))
        assert got == _jax(j_api.cache_specs(jcfg, js)), js.name
        assert got


@pytest.mark.parametrize("arch", ARCHS)
def test_get_shapes_matches_the_jax_registry(arch):
    assert ([dataclasses.astuple(s) for s in get_shapes(arch)]
            == [dataclasses.astuple(s) for s in j_get_shapes(arch)])
    fam = get_config(arch).family
    assert ([dataclasses.astuple(s) for s in shapes.skipped_shapes(fam)]
            == [dataclasses.astuple(s)
                for s in j_shapes.skipped_shapes(fam)])


@pytest.mark.parametrize("include_skipped", [False, True])
def test_list_cells_matches_the_jax_registry(include_skipped):
    got = [(a, dataclasses.astuple(s), r)
           for a, s, r in list_cells(include_skipped)]
    want = [(a, dataclasses.astuple(s), r)
            for a, s, r in j_list_cells(include_skipped)]
    assert got == want
    assert len(got) == (40 if include_skipped else 32)


def test_shape_constants_match():
    for name in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert (dataclasses.astuple(getattr(shapes, name))
                == dataclasses.astuple(getattr(j_shapes, name)))
    assert len(shapes.SHAPES) == len(j_shapes.SHAPES) == 4

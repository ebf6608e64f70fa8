"""The port's assigned shapes (``repro_torch/configs/shapes.py``) and
``registry.assigned_names()`` against the JAX package's, for every assigned
arch x shape (40 cells): the applicability verdict, every input spec's
shape and dtype against JAX's ``ShapeDtypeStruct``, and the decode caches
(``cache_specs``: ``lm_init_caches`` on the meta device) against JAX's
``eval_shape``, leaf by path, at full size with nothing allocated.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro.checkpoint.manager import _flatten_with_paths
from repro.configs import registry as jregistry
from repro.configs import shapes as jshapes
from repro_torch.configs import registry, shapes
from repro_torch.tree import flatten_with_paths


def test_assigned_names_and_shapes_match_jax():
    assert registry.assigned_names() == jregistry.assigned_names()
    assert len(registry.ASSIGNED) == 10
    assert list(shapes.SHAPES) == list(jshapes.SHAPES)
    for name, spec in shapes.SHAPES.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(jshapes.SHAPES[name])
    # the registry keeps JAX's order: the assigned archs, then the paper's
    assert list(registry.REGISTRY) == list(jregistry.REGISTRY)


def _same_spec(got: torch.Tensor, want, what):
    assert got.device.type == "meta", what
    assert tuple(got.shape) == tuple(want.shape), what
    assert str(got.dtype).split(".")[-1] == str(want.dtype), what


@pytest.mark.parametrize("shape", list(jshapes.SHAPES))
@pytest.mark.parametrize("arch", jregistry.assigned_names())
def test_shape_cell_matches_jax(arch, shape):
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    spec, jspec = shapes.SHAPES[shape], jshapes.SHAPES[shape]
    skip = shapes.applicability(cfg, spec)
    assert skip == jshapes.applicability(jcfg, jspec)
    for fn in ("train_input_specs", "prefill_input_specs"):
        got, want = getattr(shapes, fn)(cfg, spec), getattr(jshapes, fn)(jcfg, jspec)
        assert list(got) == list(want), fn
        for k in want:
            _same_spec(got[k], want[k], f"{fn} {k}")
    _same_spec(shapes.decode_token_spec(cfg, spec), jshapes.decode_token_spec(jcfg, jspec),
               "decode_token_spec")
    got = flatten_with_paths(shapes.cache_specs(cfg, spec))
    want = _flatten_with_paths(jshapes.cache_specs(jcfg, jspec))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        _same_spec(g, w, f"cache {path}")

"""The port's spec functions against the JAX package's, exactly.

``make_rules``, ``logical_to_spec`` (through ``spec_tree``, and directly on
the q-heads ``head_dim`` fallback), ``spec_tree``, ``batch_spec`` and
``serve_lib.cache_specs`` of ``repro_torch`` are held to ``repro``'s entry
for entry, as ``tuple(spec)``, on every arch of the registry at full width
(every family's cache included), on device-less meshes: JAX's
``AbstractMesh`` for the reference, the port's abstract ``Mesh`` of the
same axes and sizes. The meshes are (1, 1), (1, 2), (2, 2), (1, 4) and the
reference's production meshes (16, 16) and (2, 16, 16), under the default
rules, ``zero3``, ``seq_parallel`` and ``dp_only``.
"""

import jax
import pytest
from jax.sharding import AbstractMesh, PartitionSpec as JP

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.runtime import serve_lib as jax_serve_lib
from repro.sharding import rules as jax_rules
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.mesh import (abstract_mesh, make_local_mesh,
                                     make_production_mesh)
from repro_torch.models import build_model
from repro_torch.models.param import tree_items
from repro_torch.runtime import serve_lib
from repro_torch.sharding import (PartitionSpec, batch_spec, current_mesh,
                                  data_axes, local_slices, logical_to_spec,
                                  make_rules, mesh_context, model_axis,
                                  spec_tree)
from repro_torch.sharding.context import axis_size

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "1x2": ((1, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
OPTIONS = {"default": {}, "zero3": {"zero3": True},
           "seq_parallel": {"seq_parallel": True},
           "dp_only": {"dp_only": True},
           "dp_only+zero3": {"dp_only": True, "zero3": True}}
ARCHS = list_archs()


def meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), abstract_mesh(shape, axes)


def jax_leaves(tree) -> list:
    """(path, tuple(spec)) of a tree of jax PartitionSpec, dict keys and
    NamedTuple fields by name, in ``tree_items``' order."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    out = [(tuple(getattr(k, "key", getattr(k, "name", None))
                  for k in path), tuple(spec)) for path, spec in flat]
    return sorted(out)


def port_leaves(tree) -> list:
    return sorted((path, tuple(spec)) for path, spec in tree_items(tree)
                  if spec is not None)


@pytest.mark.parametrize("option", OPTIONS)
@pytest.mark.parametrize("mesh", MESHES)
def test_make_rules(mesh, option):
    jmesh, tmesh = meshes(mesh)
    want = jax_rules.make_rules(jmesh, **OPTIONS[option])
    got = make_rules(tmesh, **OPTIONS[option])
    assert got == want


@pytest.mark.parametrize("option", OPTIONS)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tree(arch, mesh, option):
    jmesh, tmesh = meshes(mesh)
    jmodel = jax_build_model(jax_get_config(arch))
    model = build_model(get_config(arch))
    want = jax_rules.spec_tree(jmodel.param_decls(), jmesh,
                               jax_rules.make_rules(jmesh, **OPTIONS[option]))
    got = spec_tree(model.param_decls(), tmesh,
                    make_rules(tmesh, **OPTIONS[option]))
    assert all(isinstance(s, PartitionSpec) for _, s in tree_items(got))
    assert port_leaves(got) == jax_leaves(want)


@pytest.mark.parametrize("mesh", ["1x4", "16x16", "2x16x16"])
@pytest.mark.parametrize("axes,shape", [
    # q heads that do not divide fall back to head_dim; K/V never do
    (("layers", "embed", "heads", "head_dim"), (2, 64, 6, 128)),
    (("layers", "heads", "head_dim", "embed"), (2, 6, 128, 64)),
    (("layers", "embed", "kv_heads", "head_dim"), (2, 64, 6, 128)),
    # a vocab that does not divide stays replicated
    (("vocab", "embed"), (50280, 64)),
    (("embed", "vocab"), (64, 50280)),
    # a dim used twice takes the axis once
    (("mlp", "mlp"), (64, 64)),
])
@pytest.mark.parametrize("option", OPTIONS)
def test_logical_to_spec(option, axes, shape, mesh):
    jmesh, tmesh = meshes(mesh)
    want = jax_rules.logical_to_spec(
        axes, shape, jax_rules.make_rules(jmesh, **OPTIONS[option]), jmesh)
    got = logical_to_spec(axes, shape, make_rules(tmesh, **OPTIONS[option]),
                          tmesh)
    assert tuple(got) == tuple(want)


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("mesh", MESHES)
def test_batch_spec(mesh, ndim):
    jmesh, tmesh = meshes(mesh)
    assert tuple(batch_spec(tmesh, ndim)) == tuple(
        jax_rules.batch_spec(jmesh, ndim))


@pytest.mark.parametrize("max_len", [544, 545])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs(arch, mesh, batch, max_len):
    """Every family's cache specs, leaf by leaf by field name; 545 rows
    divide over no model axis here, and a batch of 1 over no data axis
    (the long-context branch: the sequence takes every axis). The port's
    encoder-decoder cache also holds ``cross_length``, one scalar the
    reference's has not: its spec is P()."""
    jmesh, tmesh = meshes(mesh)
    jmodel = jax_build_model(jax_get_config(arch))
    model = build_model(get_config(arch))
    want = jax_leaves(jax_serve_lib.cache_specs(jmodel, jmesh, batch,
                                                max_len))
    got = port_leaves(serve_lib.cache_specs(model, tmesh, batch, max_len))
    extra = [leaf for leaf in got if leaf[0] == ("cross_length",)]
    assert extra == ([(("cross_length",), ())]
                     if model.cfg.family == "encdec" else [])
    assert [leaf for leaf in got if leaf not in extra] == want


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_cache_matches_the_reference(arch):
    """The meta-device cache has the reference's shapes (the port's K/V
    length is one scalar where the reference's is one a layer)."""
    jmodel = jax_build_model(jax_get_config(arch))
    model = build_model(get_config(arch))
    kw = {"memory_len": 64} if model.cfg.family == "encdec" else {}
    want = dict(jax_leaves(jax.tree.map(
        lambda a: JP(*a.shape), jax_serve_lib.abstract_cache(
            jmodel, 2, 64, filled=False, **kw))))
    got = serve_lib.abstract_cache(model, 2, 64, filled=False, **kw)
    for path, a in tree_items(got):
        if a is None:
            continue
        assert a.device.type == "meta"
        if path[-1] in ("length", "cross_length"):
            assert a.shape == ()
        else:
            assert tuple(a.shape) == want[path], path


@pytest.mark.parametrize("mesh", MESHES)
def test_context_functions(mesh):
    jmesh, tmesh = meshes(mesh)
    from repro.sharding import context as jax_context
    assert data_axes(tmesh) == jax_context.data_axes(jmesh)
    assert model_axis(tmesh) == jax_context.model_axis(jmesh)
    for name in ("pod", "data", "model", "other"):
        assert axis_size(name, tmesh) == jax_context.axis_size(name, jmesh)
    default = current_mesh()
    assert default.axis_names == ("data", "model") \
        and dict(default.shape) == {"data": 1, "model": 1}
    with mesh_context(tmesh):
        assert current_mesh() is tmesh and data_axes() == data_axes(tmesh)
    assert current_mesh() is default


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh(multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    want = MESHES["2x16x16" if multi_pod else "16x16"]
    assert (tuple(mesh.shape.values()), mesh.axis_names) == want
    assert not mesh.is_live and mesh.size == (512 if multi_pod else 256)


def test_local_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_local_mesh(1, 2)


@pytest.mark.parametrize("coords,want", [
    ({"pod": 0, "data": 0, "model": 0}, (slice(0, 4), slice(0, 16))),
    ({"pod": 1, "data": 0, "model": 3}, (slice(64, 68), slice(48, 64))),
    ({"pod": 1, "data": 15, "model": 15}, (slice(124, 128),
                                           slice(240, 256)))])
def test_local_slices_cut_the_major_axis_first(coords, want):
    """A dim over ('pod', 'data') is cut pod-major, as JAX cuts it."""
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh((2, 16, 16), ("pod", "data", "model"), coords=coords)
    spec = PartitionSpec(("pod", "data"), "model")
    assert local_slices(spec, (128, 256), mesh) == want


@pytest.mark.parametrize("mesh", ["1x2", "2x2", "1x4"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-moe-235b-a22b"])
def test_sharding_tree_is_each_specs_local_slices(arch, mesh):
    """``sharding_tree``: each leaf's ``local_slices`` of its spec, at every
    coordinate of the mesh; the slices of the model axis tile each cut
    dim."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding import sharding_tree
    shape, axes = MESHES[mesh]
    decls = build_model(get_config(arch)).param_decls()
    starts = {}
    for d in range(shape[0]):
        for m in range(shape[1]):
            rank = Mesh(shape, axes, coords={"data": d, "model": m})
            rules = make_rules(rank)
            specs = spec_tree(decls, rank, rules)
            got = sharding_tree(decls, rank, rules)
            for (path, sl), (_, spec), (_, decl) in zip(
                    tree_items(got), tree_items(specs), tree_items(decls)):
                assert sl == local_slices(spec, decl.shape, rank)
                starts.setdefault(path, set()).add(
                    tuple(s.start for s in sl))
    for path, spec in tree_items(specs):
        cut = sum(part == "model" for part in spec)
        assert len(starts[path]) == (shape[1] if cut else 1), path

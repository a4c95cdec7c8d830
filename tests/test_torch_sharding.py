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

import math

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


# ------------------------------------------------------- sharded training
from repro.runtime import train_lib as jax_train_lib        # noqa: E402
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro_torch.optim import AdamWConfig                   # noqa: E402
from repro_torch.runtime import train_lib                   # noqa: E402

TRAIN_MESHES = ["1x2", "2x2", "1x4", "16x16", "2x16x16"]
TRAIN_OPTIONS = {"default": {}, "zero1": {"zero1": True},
                 "zero3": {"zero3": True},
                 "zero1+zero3": {"zero1": True, "zero3": True}}


def _dp_only(arch: str, dp_only: bool):
    """(JAX model, port model) of ``arch`` at full width, ``dp_only`` set
    on both by ``dataclasses.replace``."""
    import dataclasses
    return (jax_build_model(dataclasses.replace(jax_get_config(arch),
                                                dp_only=dp_only)),
            build_model(dataclasses.replace(get_config(arch),
                                            dp_only=dp_only)))


@pytest.mark.parametrize("dp_only", [False, True], ids=["", "dp_only"])
@pytest.mark.parametrize("option", TRAIN_OPTIONS)
@pytest.mark.parametrize("mesh", TRAIN_MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_make_train_state_specs(arch, mesh, option, dp_only):
    """The TrainState's specs, parameters and both moments (ZeRO-1's under
    the ZeRO-3 rules) and the step's P(), leaf for leaf by field name."""
    jmesh, tmesh = meshes(mesh)
    jmodel, model = _dp_only(arch, dp_only)
    want = jax_train_lib.make_train_state_specs(jmodel, jmesh,
                                                **TRAIN_OPTIONS[option])
    got = train_lib.make_train_state_specs(model, tmesh,
                                           **TRAIN_OPTIONS[option])
    assert port_leaves(got) == jax_leaves(want)


def _batch_trees(B: int):
    """One training batch of every kind the reference's steps take:
    tokens, a mask, a vlm's vision embeddings and M-RoPE positions, an
    encoder-decoder's frames: (JAX ShapeDtypeStruct tree, port meta
    tree)."""
    import torch
    shapes = {"tokens": ((B, 17), "int32"), "mask": ((B, 16), "float32"),
              "vision_embeds": ((B, 4, 64), "bfloat16"),
              "mrope_positions": ((3, B, 16), "int32"),
              "frames": ((B, 32, 64), "bfloat16")}
    jtree = {k: jax.ShapeDtypeStruct(s, getattr(jax.numpy, d))
             for k, (s, d) in shapes.items()}
    ttree = {k: torch.empty(s, dtype=getattr(torch, d), device="meta")
             for k, (s, d) in shapes.items()}
    return jtree, ttree


@pytest.mark.parametrize("dp_only", [False, True], ids=["", "dp_only"])
@pytest.mark.parametrize("mesh", MESHES)
def test_batch_sharding(mesh, dp_only):
    """Every leaf's spec equals the reference's at B = 8 (the leading dim
    over the data axes, with ``dp_only`` the model axis too; the M-RoPE
    positions (3, B, S) on axis 1)."""
    jmesh, tmesh = meshes(mesh)
    jtree, ttree = _batch_trees(8)
    want = jax_train_lib.batch_sharding(jmesh, jtree, dp_only=dp_only)
    got = train_lib.batch_sharding(tmesh, ttree, dp_only=dp_only)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("mesh", ["1x2", "2x2", "1x4", "16x16", "2x16x16"])
def test_batch_sharding_of_a_vlm_batch(mesh):
    """A vlm batch, tokens, vision embeddings (B, nv, M) and M-RoPE
    positions (3, B, S), at B = 64: every leaf's spec equals the
    reference's; the embeddings are cut as the tokens on their batch axis
    and the positions on axis 1. At one microbatch the rows the sharded
    step takes on each batch rank (``train_lib.group_rows``) are that
    rank's span of the spec; at two, each rank takes its part of each
    global microbatch, the same number of rows."""
    import torch
    from repro_torch.sharding.rules import local_slices
    jmesh, tmesh = meshes(mesh)
    B = 64
    shapes = {"tokens": ((B, 17), "int32"),
              "vision_embeds": ((B, 4, 64), "bfloat16"),
              "mrope_positions": ((3, B, 16), "int32")}
    jtree = {k: jax.ShapeDtypeStruct(s, getattr(jax.numpy, d))
             for k, (s, d) in shapes.items()}
    ttree = {k: torch.empty(s, dtype=getattr(torch, d), device="meta")
             for k, (s, d) in shapes.items()}
    want = jax_train_lib.batch_sharding(jmesh, jtree)
    got = train_lib.batch_sharding(tmesh, ttree)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}
    lead = tuple(got["tokens"])[0]
    assert tuple(got["vision_embeds"]) == (lead, None, None)
    assert tuple(got["mrope_positions"]) == (None, lead, None)
    n = math.prod(tmesh.shape[a] for a in tmesh.axis_names
                  if a != "model")
    spans = set()
    for index in range(n):
        coords = dict(zip(tmesh.axis_names, divmod(index, n // 2)
                          if len(tmesh.axis_names) == 3 else (index, 0)))
        rank = abstract_mesh(tuple(tmesh.shape.values()),
                             tmesh.axis_names)
        rank.coords.update(coords)
        span = local_slices(got["tokens"], (B, 17), rank)[0]
        assert train_lib.group_rows(B, 1, n, index, 0) == span
        rows = [r for i in range(2)
                for r in range(B)[train_lib.group_rows(B, 2, n, index, i)]]
        assert len(rows) == B // n
        spans.update(rows)
    assert spans == set(range(B))


@pytest.mark.parametrize("mesh", ["1x2", "2x2", "16x16"])
def test_batch_sharding_goes_by_name_at_a_batch_of_3(mesh):
    """The one departure, pinned: at B = 3 the reference takes an int
    leaf with a leading 3 for M-RoPE positions and cuts a token batch on
    its sequence axis; the port cuts it on its batch axis (by the leaf's
    name), and the positions' (3, 3, S) on axis 1 as the reference
    does."""
    jmesh, tmesh = meshes(mesh)
    jtree, ttree = _batch_trees(3)
    want = jax_train_lib.batch_sharding(jmesh, jtree)
    got = train_lib.batch_sharding(tmesh, ttree)
    lead = tuple(want["mask"])[0]
    assert tuple(want["tokens"]) == (None, lead)
    assert tuple(got["tokens"]) == (lead, None)
    for k in ("mask", "vision_embeds", "mrope_positions", "frames"):
        assert tuple(got[k]) == tuple(want[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_train_state_matches_the_reference(arch):
    """Every leaf's shape and dtype equals the reference's
    ``ShapeDtypeStruct``, on the meta device."""
    jmodel = jax_build_model(jax_get_config(arch))
    model = build_model(get_config(arch))
    want = jax_train_lib.abstract_train_state(
        jmodel, AbstractMesh((1, 2), ("data", "model")), JaxAdamWConfig())
    got = train_lib.abstract_train_state(model, AdamWConfig())
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    want = {tuple(getattr(k, "key", getattr(k, "name", None))
                  for k in path): (tuple(a.shape), str(a.dtype))
            for path, a in flat}
    got_items = tree_items(got)
    assert len(got_items) == len(want)
    for path, a in got_items:
        assert a.device.type == "meta"
        assert (tuple(a.shape), str(a.dtype).split(".")[1]) == want[path], \
            path


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2"])
def test_sharded_training_refuses_other_families(monkeypatch, arch):
    """Every family of the JAX package trains sharded: the hybrid and the
    encoder-decoder, refused until their slice, now pass the family check
    and reach the live-mesh check (``ValueError``) before anything is
    allocated (``tests/test_torch_train_sharded_hybrid_encdec.py`` trains
    them). A family that the sharded execution does not know raises
    ``NotImplementedError`` naming A.12 before it allocates."""
    import dataclasses
    model = build_model(get_config(arch, reduced=True))
    monkeypatch.setattr(train_lib, "init_params", _no_allocation)
    with pytest.raises(ValueError, match="process group"):
        train_lib.build_train_step(model, AdamWConfig(),
                                   mesh=abstract_mesh((1, 2)))
    model.cfg = dataclasses.replace(model.cfg, family="rnn")
    with pytest.raises(NotImplementedError, match="(?s)rnn.*A.12"):
        train_lib.build_train_step(model, AdamWConfig(),
                                   mesh=abstract_mesh((1, 2)))


def _no_allocation(*args, **kw):
    raise AssertionError("allocated before the refusal")


@pytest.mark.parametrize("mesh", [None, (2, 2)])
def test_zero3_raises_before_allocating(monkeypatch, mesh):
    """ZeRO-3 without a mesh raises ``ValueError`` (pass the mesh) before
    anything is allocated, in the step and in the state; on a (2, 2) mesh
    with no process group behind it the step raises for the group before
    it allocates, and the state of each rank holds its ZeRO-3 region of
    every leaf alone (the ZeRO-3 specs' local shapes, the moments alike;
    ``tests/test_torch_zero3.py`` runs the step)."""
    model = build_model(get_config("tinyllama-1.1b", reduced=True))
    if mesh is None:
        monkeypatch.setattr(train_lib, "init_params", _no_allocation)
        with pytest.raises(ValueError, match="pass the mesh"):
            train_lib.build_train_step(model, AdamWConfig(), zero3=True)
        with pytest.raises(ValueError, match="pass the mesh"):
            train_lib.init_train_state(model, AdamWConfig(), device="cpu",
                                       zero3=True)
        return
    with monkeypatch.context() as mp:
        mp.setattr(train_lib, "init_params", _no_allocation)
        with pytest.raises(ValueError, match="process group"):
            train_lib.build_train_step(model, AdamWConfig(), zero3=True,
                                       mesh=abstract_mesh(mesh))
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.param import tree_at
    from repro_torch.sharding.rules import local_shape
    decls = dict(tree_items(model.param_decls()))
    for coords in ({"data": 0, "model": 1}, {"data": 1, "model": 0}):
        rank = Mesh(mesh, ("data", "model"), coords=coords)
        specs = train_lib.make_train_state_specs(model, rank, zero3=True)
        state = train_lib.init_train_state(model, AdamWConfig(),
                                           device="cpu", mesh=rank,
                                           zero3=True)
        for tree, spec_tree_ in ((state.params, specs.params),
                                 (state.opt.m, specs.opt.m),
                                 (state.opt.v, specs.opt.v)):
            for path, leaf in tree_items(tree):
                want = local_shape(tree_at(spec_tree_, path),
                                   decls[path].shape, rank)
                assert tuple(leaf.shape) == want, path
                # every leaf of the reduced tinyllama is cut over the data
                # axis, on a dim the model axis leaves whole
                spec = tree_at(spec_tree_, path)
                assert "data" in spec, (path, spec)
                assert math.prod(want) * 2 * 2 ** ("model" in spec) == \
                    math.prod(decls[path].shape), path


def test_the_sharded_step_needs_a_live_mesh():
    model = build_model(get_config("tinyllama-1.1b", reduced=True))
    with pytest.raises(ValueError, match="process group"):
        train_lib.build_train_step(model, AdamWConfig(),
                                   mesh=abstract_mesh((1, 2)))


def test_a_sharded_checkpoint_raises_before_allocating(monkeypatch,
                                                       tmp_path):
    """``train_loop`` over more than one rank, with ``ckpt_dir`` or
    without, needs a live process group: with none up,
    ``make_local_mesh`` raises before anything is set up. (Sharded
    checkpoints, refused naming A.12 until their slice, are held by
    ``tests/test_torch_ckpt_sharded.py``.)"""
    from repro_torch.launch import train as train_mod
    monkeypatch.setattr(train_mod, "setup_training", _no_allocation)
    with pytest.raises(RuntimeError, match="process group"):
        train_mod.train_loop("tinyllama-1.1b", reduced=True, device="cpu",
                             data=1, model=2, ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="process group"):
        train_mod.train_loop("tinyllama-1.1b", reduced=True, device="cpu",
                             data=2, model=1)


def test_enter_without_grad_runs_no_collective(monkeypatch):
    """``ShardLayout.enter`` under ``no_grad`` (and on a tensor that needs
    no gradient) returns its input and calls no collective, so the serving
    steps keep their all_reduce calls."""
    import torch
    from repro_torch.sharding.layout import ShardLayout, Span
    calls = []
    monkeypatch.setattr(torch.distributed, "all_reduce",
                        lambda *a, **k: calls.append(a))
    layout = ShardLayout(mesh=abstract_mesh((1, 2)),
                         vocab=Span(0, 128, 256, ("model",)),
                         batch=Span(0, 8, 8), heads=Span(0, 2, 4, ("model",)))
    x = torch.randn(2, 3, requires_grad=True)
    with torch.no_grad():
        assert layout.enter(x) is x
    with torch.inference_mode():
        y = torch.randn(2, 3)
        assert layout.enter(y) is y
    z = torch.randn(2, 3)
    assert layout.enter(z) is z
    assert calls == []

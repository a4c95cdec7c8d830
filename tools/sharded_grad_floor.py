"""How far a bf16 train step's gradients stand from the fp32 step's, on one
card: the unsharded step and the (1, 2) sharded step, each with cuBLAS's
reduced-precision reductions of bf16 products off (as
``runtime/train_lib.py::fp32_reductions`` runs every train step) and on
(PyTorch's default).

    python3 tools/sharded_grad_floor.py [arch]      # card only, ~4 min

``arch`` defaults to seamless-m4t-large-v2, at ``chip_smoke.py``'s sharded
training config (6 + 6 layers at full width, batch 8 x 512 over 1024
frames, remat "full", the attention at fan-in std; jamba-1.5-large-398b
its reduced block, every step fed the first step's experts, ROADMAP C.2,
its bf16 steps in bf16 whatever ``SHARD_TRAIN_FP32`` says). The fp32
step is the same model with every weight cast to fp32 (each leaf's
gradient then differs from the bf16 steps' by their roundings alone). For each bf16
step, and for the sharded fp32 step against the unsharded one, the worst
leaves' ||g - g_ref|| / ||g_ref|| over each rank's slice are printed, as
``chip_smoke.py::sharded_train_check`` holds a rank's gradient shards
(rule 3e-2 against the unsharded bf16 step). The ranks are two processes
sharing the card over gloo, as in ``sharded_train_check``.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402

REFS = ROOT / "build" / "sharded_grad_floor_refs.pt"
# (name, dtype fp32, reduced-precision reductions on)
STEPS = (("bf16", False, False), ("bf16, reductions on", False, True),
         ("fp32", True, False))


@contextlib.contextmanager
def _reductions_on():
    """``fp32_reductions``' stand-in that leaves PyTorch's default."""
    yield


def step_grads(arch: str, batch: dict, fp32: bool, reduced: bool,
               mesh=None, routes: list | None = None) -> dict:
    """One train step's gradients (fp32, on the host, by path) from the
    seeded state, unsharded or this rank's shards over ``mesh``. An MoE's
    layers take ``routes``' top-k experts (``chip_smoke.experts_as``) or,
    with ``routes`` empty, record theirs into it (one a layer)."""
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_items, tree_map
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import train_lib
    cfg = smoke.sharded_train_config(arch)
    model = build_model(cfg)
    opt = AdamWConfig(**smoke.SHARD_TRAIN_OPT)
    state = train_lib.init_train_state(model, opt, seed=0, device="cuda",
                                       mesh=mesh)
    smoke.attention_at_fan_in(state.params, cfg)
    if fp32:
        state = train_lib.TrainState(tree_map(lambda a: a.float(),
                                              state.params), state.opt)
    seen = {}

    def capture(update):
        def recording(params, grads, *args):
            seen.update({"/".join(p): g.detach().float().cpu()
                         for p, g in tree_items(grads)})
            return update(params, grads, *args)
        return recording
    name = "adamw_update" if mesh is None else "adamw_update_sharded"
    recorded = {"cuda": [], "cpu": []}
    with contextlib.ExitStack() as stack:
        stack.enter_context(smoke.patched(train_lib, name, capture))
        if cfg.n_experts:
            stack.enter_context(smoke.experts_as(routes) if routes
                                else smoke.record_routes(recorded))
        if reduced:
            stack.enter_context(smoke.patched(
                train_lib, "fp32_reductions", lambda _: _reductions_on))
        step = train_lib.build_train_step(model, opt, mesh=mesh)
        step(state, {k: t.cuda() for k, t in batch.items()})
    if cfg.n_experts and not routes:
        n_moe = cfg.n_layers // cfg.hybrid_moe_every \
            if cfg.family == "hybrid" else cfg.n_layers
        routes.extend((t,) for t, _, _ in recorded["cuda"][:n_moe])
    return seen


def _rank(rank: int, arch: str, init: str, queue) -> None:
    import traceback
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{init}",
                                world_size=2, rank=rank,
                                timeout=datetime.timedelta(seconds=900))
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.models import build_model
        from repro_torch.models.param import tree_at, tree_items
        from repro_torch.runtime import train_lib
        from repro_torch.sharding.rules import local_slices
        mesh = make_local_mesh(1, 2)
        refs = torch.load(REFS, mmap=True)
        model = build_model(smoke.sharded_train_config(arch))
        specs = train_lib.make_train_state_specs(model, mesh)
        region = {"/".join(p): local_slices(tree_at(specs.params, p),
                                            d.shape, mesh)
                  for p, d in tree_items(model.param_decls())}
        out = {}
        for name, fp32, reduced in STEPS:
            got = step_grads(arch, refs["batch"], fp32, reduced, mesh,
                             refs["routes"])
            against = "fp32" if fp32 else "bf16"
            out[name] = {k: (_rel(g, refs["fp32"][k][region[k]]),
                             _rel(g, refs[against][k][region[k]]))
                         for k, g in got.items()}
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _rel(got, want) -> float:
    den = float(want.norm())
    return float((got - want).norm()) / den if den else 0.0


def _worst(errs: dict, index: int, n: int = 4) -> str:
    items = sorted(errs.items(), key=lambda kv: -kv[1][index])[:n]
    return ", ".join(f"{k} {e[index]:.3e}" for k, e in items)


def main() -> int:
    arch = sys.argv[1] if len(sys.argv) > 1 else smoke.SEAMLESS_ARCH
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("sharded_grad_floor: no CUDA device", file=sys.stderr)
        return 2
    _build.build()
    smoke.log(f"[card] {smoke.card_line()}")
    batch = smoke.sharded_train_batch(torch, smoke.sharded_train_config(
        arch))
    refs = {"batch": batch, "routes": []}
    unsharded = {}
    for name, fp32, reduced in STEPS:
        # an MoE's first step records its experts, the others take them
        unsharded[name] = step_grads(arch, batch, fp32, reduced,
                                     routes=refs["routes"])
        torch.cuda.empty_cache()
    refs["fp32"], refs["bf16"] = unsharded["fp32"], unsharded["bf16"]
    REFS.parent.mkdir(exist_ok=True)
    torch.save(refs, REFS)
    truth = unsharded["fp32"]
    for name in ("bf16", "bf16, reductions on"):
        errs = {k: (_rel(g, truth[k]),) for k, g in unsharded[name].items()}
        smoke.log(f"[floor] {arch} unsharded {name} against the unsharded "
                  f"fp32 step, worst leaves: {_worst(errs, 0)}")
    del refs, unsharded
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        queue = ctx.Queue()
        procs = [ctx.Process(target=_rank, args=(r, arch,
                                                 os.path.join(tmp, "init"),
                                                 queue))
                 for r in range(2)]
        for p in procs:
            p.start()
        results = dict(queue.get(timeout=1800) for _ in procs)
        for p in procs:
            p.join()
    REFS.unlink(missing_ok=True)
    for rank, out in sorted(results.items()):
        if isinstance(out, str):
            print(out, file=sys.stderr)
            return 1
        for name, _, _ in STEPS:
            against = "fp32" if name == "fp32" else "bf16"
            smoke.log(f"[floor] {arch} (1, 2) rank {rank} sharded {name}: "
                      f"against the unsharded fp32 step {_worst(out[name], 0)}"
                      f"; against the unsharded {against} step (reductions "
                      f"off) {_worst(out[name], 1)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

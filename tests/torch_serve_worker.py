"""One rank of a sharded serving group on the CPU, for
``tests/test_torch_serve_lib.py``: a gloo process group over a ``file://``
rendezvous, the port's (data, model) mesh, and for each case the sharded
prefill and teacher-forced decode steps of ``runtime/serve_lib.py`` (an
MoE case also fed a routing). It imports no JAX, so a spawned rank starts
with torch alone."""

from __future__ import annotations

import contextlib
import traceback

import torch
import torch.distributed as dist


def _shapes(tree) -> dict:
    from repro_torch.models.param import tree_items
    return {"/".join(path): tuple(a.shape) for path, a in tree_items(tree)
            if a is not None}


def _steps(model, mesh, params, tokens, prompt: int, max_len: int,
           span=None) -> tuple:
    """The sharded prefill of ``tokens[:, :prompt]`` and a decode step fed
    each of ``tokens[:, prompt:]``: (each step's logits, fp32 numpy, the
    whole batch; the cache after; each decode step's valid keys in
    ``span``, this rank's rows of the K/V cache)."""
    from repro_torch.runtime import serve_lib
    B, T = tokens.shape
    cache = serve_lib.init_cache_shards(model, mesh, B, max_len,
                                        device="cpu")
    prefill = serve_lib.build_prefill_step(model, mesh, B, prompt, max_len)
    decode = serve_lib.build_decode_step(model, mesh, B, max_len)
    out, keys = [], []
    with torch.inference_mode():
        logits, cache = prefill(params, tokens[:, :prompt], cache)
        out.append(logits.float().numpy())
        for t in range(prompt, T):
            if span is not None:
                # the rank's valid keys in this step, once the token is
                # written
                keys.append(max(0, min(t + 1 - span.start, span.size)))
            logits, cache = decode(params, tokens[:, t:t + 1], cache)
            out.append(logits.float().numpy())
    return out, cache, keys


@contextlib.contextmanager
def _routing(rows: slice, batch: int, fed: list | None, own: list):
    """Context: each call of the port's MoE routing appends its own
    (topi, gates, router logits) to ``own``; with ``fed`` (one (topi,
    gates) a call, numpy, the whole batch's T rows), it returns the fed
    routing's ``rows`` of the batch in place of its own."""
    import importlib
    from repro_torch.models.common import matmul
    moe_mod = importlib.import_module("repro_torch.models.moe")
    route, calls = moe_mod._route, iter(fed or ())

    def routed(router, x, cfg):
        topi, gates, aux = route(router, x, cfg)
        own.append((topi.numpy(), gates.numpy(), matmul(
            x.float().reshape(-1, x.shape[-1]), router).numpy()))
        if fed is None:
            return topi, gates, aux
        k = cfg.top_k
        topi, gates = (torch.as_tensor(a).reshape(batch, -1, k)[rows]
                       .reshape(-1, k) for a in next(calls))
        return topi, gates, aux
    moe_mod._route = routed
    try:
        yield
    finally:
        moe_mod._route = route


def serve_case(mesh, case: dict) -> dict:
    """The sharded prefill and teacher-forced decode steps (``_steps``) on
    ``case["params"]`` cut to this rank's shards. Returns the logits of
    each step (fp32 numpy, the whole batch), this rank's parameter and
    cache shapes, and its cache after the steps: with a K/V cache, each
    decode step's valid keys in this rank's span; with an SSM cache, its
    heads. An MoE case also returns its routing of each call (``routes``)
    and runs again fed the case's ``routes`` of its data axis's size
    (``logits_fed``; its K/V cache is the fed run's)."""
    from repro_torch.models import build_model
    from repro_torch.models.param import shard_params
    from repro_torch.runtime import serve_lib
    model = build_model(case["cfg"])
    tokens = torch.as_tensor(case["tokens"])
    B = tokens.shape[0]
    S, max_len = case["prompt"], case["max_len"]
    layout = serve_lib.shard_layout(model, mesh, B, max_len)
    params = shard_params(case["params"], serve_lib.param_specs(model, mesh),
                          mesh)
    span = layout.seq
    out = {"params": _shapes(params),
           "cache": _shapes(serve_lib.init_cache_shards(
               model, mesh, B, max_len, device="cpu"))}
    own = []
    with _routing(layout.batch.slice(), B, None, own):
        out["logits"], cache, keys = _steps(model, mesh, params, tokens, S,
                                            max_len, span)
    if "routes" in case:
        out["routes"] = own
        fed = case["routes"][mesh.shape["data"]]
        with _routing(layout.batch.slice(), B, fed, []):
            out["logits_fed"], cache, _ = _steps(model, mesh, params, tokens,
                                                 S, max_len, span)
    if span is None:
        out["heads"] = (layout.ssm_heads.start, layout.ssm_heads.size)
        out["ssm"] = tuple(a.numpy() for a in cache.ssm)
    else:
        out.update(span_keys=keys, span=(span.start, span.size),
                   length=int(cache.kv.length),
                   kv=(cache.kv.k.float().numpy(),
                       cache.kv.v.float().numpy()))
    return out


def run_rank(rank: int, data: int, model: int, init_file: str,
             cases: dict, queue) -> None:
    """Rank ``rank`` of a ``data`` x ``model`` gloo group: every case, then
    ``(rank, results or the traceback)`` on ``queue``."""
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                world_size=data * model, rank=rank)
        from repro_torch.launch.mesh import make_local_mesh
        mesh = make_local_mesh(data, model, device_type="cpu")
        results = {"coords": dict(mesh.coords)}
        results.update({name: serve_case(mesh, case)
                        for name, case in cases.items()})
        queue.put((rank, results))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

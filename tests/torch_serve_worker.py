"""One rank of a sharded serving group on the CPU, for
``tests/test_torch_serve_lib.py``: a gloo process group over a ``file://``
rendezvous, the port's (data, model) mesh, and for each case the sharded
prefill and teacher-forced decode steps of ``runtime/serve_lib.py``. It
imports no JAX, so a spawned rank starts with torch alone."""

from __future__ import annotations

import traceback

import torch
import torch.distributed as dist


def _shapes(tree) -> dict:
    from repro_torch.models.param import tree_items
    return {"/".join(path): tuple(a.shape) for path, a in tree_items(tree)
            if a is not None}


def serve_case(mesh, case: dict) -> dict:
    """The sharded prefill of ``tokens[:, :prompt]`` and a decode step fed
    each of ``tokens[:, prompt:]``, on ``case["params"]`` cut to this
    rank's shards. Returns the logits of each step (fp32 numpy, the whole
    batch), this rank's parameter and cache shapes and each decode step's
    valid keys in this rank's span."""
    from repro_torch.models import build_model
    from repro_torch.models.param import shard_params
    from repro_torch.runtime import serve_lib
    model = build_model(case["cfg"])
    tokens = torch.as_tensor(case["tokens"])
    B, T = tokens.shape
    S, max_len = case["prompt"], case["max_len"]
    layout = serve_lib.shard_layout(model, mesh, B, max_len)
    params = shard_params(case["params"], serve_lib.param_specs(model, mesh),
                          mesh)
    cache = serve_lib.init_cache_shards(model, mesh, B, max_len,
                                        device="cpu")
    prefill = serve_lib.build_prefill_step(model, mesh, B, S, max_len)
    decode = serve_lib.build_decode_step(model, mesh, B, max_len)
    out = {"params": _shapes(params), "cache": _shapes(cache), "logits": [],
           "span_keys": [], "span": (layout.seq.start, layout.seq.size)}
    with torch.inference_mode():
        logits, cache = prefill(params, tokens[:, :S], cache)
        out["logits"].append(logits.float().numpy())
        for t in range(S, T):
            # the rank's valid keys in this step, once the token is written
            out["span_keys"].append(
                max(0, min(t + 1 - layout.seq.start, layout.seq.size)))
            logits, cache = decode(params, tokens[:, t:t + 1], cache)
            out["logits"].append(logits.float().numpy())
        out["length"] = int(cache.kv.length)
        out["kv"] = (cache.kv.k.float().numpy(), cache.kv.v.float().numpy())
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

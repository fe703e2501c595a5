#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ditl_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Every phase is fatal: a failure raises, the script exits non-zero and prints
no result line. It imports nothing of JAX or of the JAX package.

1. Card: CUDA must be present; prints ``nvidia-smi`` name and power limit.
2. Build: every ``ditl_tpu_torch/csrc/*.cu`` with nvcc for sm_90a, one nvcc
   per source, all started together; prints ptxas' register/spill lines.
3. Kernels against their plain PyTorch versions on the card, at the serving
   prefill shapes and at ragged ones (tolerances at ``O_TOL``/``LSE_TOL``).
4. Timings: each kernel, its plain version, one PyTorch library call that
   computes the same function (a yardstick the port never calls), and the
   card's bound for the same work from this run's inputs.
5. Main path: the lock-step OpenAI server, ``llama3-8b`` at full width and
   depth (32 layers), ``attention_impl=flash``, seed-initialised weights,
   run in-process on a thread so the kernel's launch counter can be read.
   Launch counts are zeroed just before the requests and read just after.
6. The kernels line, then the result line, last.

f32 matrix products run in full f32 here (TF32 off, set below): the port's
lm head takes f32 products of bf16 values, as the JAX package's logits do.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

# bf16 outputs: the kernel rounds p to bf16 against its running row max, the
# plain version against the final max, and both round o to bf16, so they
# differ by a few bf16 ulps of values of magnitude <= ~4.
O_TOL = 2e-2
# f32 log-sum-exp: the kernel scales the q.k sums after the product, the
# plain version scales q first, and the sums run in another order.
LSE_TOL = 1e-3
# Logits of the flash prefill against the plain-attention prefill through 32
# bf16 layers: both round every activation to bf16, at different places in
# the attention, and the residual stream is bf16; relative L2 of the logits.
LOGITS_REL_TOL = 5e-2

H100_BYTES_PER_S = 3.35e12  # HBM3, SXM data sheet
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16, SXM data sheet

KERNELS = {
    "flash_fwd": {
        "route": "cuda",
        "source": "ditl_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ditl_tpu/ops/flash_attention.py:127",
    },
}

WORDS = ("tensor card kernel shard token layer cache batch prompt decode "
         "prefill attention memory stream warp block tile scale norm head "
         "route server request weight query key value logit sample").split()


def require(ok, what="") -> None:
    """A check that holds under ``python -O`` too (``assert`` is dropped)."""
    if not ok:
        raise AssertionError(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def _text(seed: int, n_chars: int) -> str:
    rng = random.Random(seed)
    words: list[str] = []
    while sum(len(w) + 1 for w in words) < n_chars:
        words.append(rng.choice(WORDS))
    return " ".join(words)[:n_chars]


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call over back-to-back calls (CUDA events; L2 not
    flushed: a prefill's q/k/v were just written by its projections)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _attn_inputs(b, s_q, s_kv, h, kv, d, *, seed, lengths=None, packed=False):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    q, k, v = rnd(b, s_q, h, d), rnd(b, s_kv, kv, d), rnd(b, s_kv, kv, d)
    seg = None
    if lengths is not None:  # the engine's prefill: real 1, right pads 0
        pos = torch.arange(s_q, device="cuda")
        seg = (pos[None, :] < torch.tensor(lengths, device="cuda")[:, None]).to(torch.int32)
        if packed:  # the first third is another packed document
            seg[:, : s_q // 3] *= 2
        seg = seg.contiguous()
    return q, k, v, seg


def _attended_pairs(b, s_q, s_kv, causal, seg) -> int:
    """(query, key) pairs the mask admits, summed over the batch: the work
    these inputs need, per head."""
    import torch

    mask = torch.ones(b, s_q, s_kv, dtype=torch.bool, device="cuda")
    if causal:
        mask &= torch.ones(s_q, s_kv, dtype=torch.bool, device="cuda").tril()[None]
    if seg is not None:
        mask &= seg[:, :, None] == seg[:, None, :]
    return int(mask.sum())


def _flash_bound(q, k, seg, causal):
    """Least time on an H100 SXM for the forward: bytes (q, k, v read once,
    o and lse written once, segment ids read once) over HBM bandwidth,
    against the attended pairs' 4*D flops each over bf16 peak."""
    b, s_q, h, d = q.shape
    s_kv, kv = k.shape[1], k.shape[2]
    nbytes = 2 * (2 * b * s_q * h * d + 2 * b * s_kv * kv * d) + 4 * b * h * s_q
    if seg is not None:
        nbytes += 4 * seg.numel()
    flops = 4 * d * h * _attended_pairs(b, s_q, s_kv, causal, seg)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_card() -> None:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    log(smi[0])  # the card's name and power limit, as nvidia-smi gives them
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()} ({torch.cuda.get_device_name(0)})")


def phase_build() -> None:
    from ditl_tpu_torch.ops.cuda_build import build_libraries

    t0 = time.perf_counter()
    built = build_libraries()
    log(f"[build] {sorted(built)} in {time.perf_counter() - t0:.1f}s")
    for name, path in built.items():
        ptxas = path.with_suffix(".log")
        for line in (ptxas.read_text().splitlines() if ptxas.is_file() else []):
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def phase_kernels(flash) -> dict:
    """Each kernel against its plain version; returns the max abs error."""
    import torch

    cases = [  # (b, s_q, s_kv, h, kv, d, causal, lengths, packed)
        (4, 512, 512, 32, 8, 128, True, [512, 401, 230, 97], False),  # batched prefill
        (1, 512, 512, 32, 8, 128, True, [401], False),  # one request, 512 bucket
        (1, 256, 256, 32, 8, 128, True, [227], False),  # one request, 256 bucket
        (1, 128, 128, 32, 8, 128, True, [101], False),  # one request, 128 bucket
        (2, 200, 333, 16, 4, 128, False, None, False),  # ragged, non-causal
        (2, 300, 300, 8, 2, 64, True, [300, 170], True),  # head_dim 64, packed
        (1, 130, 130, 4, 4, 32, True, None, False),  # head_dim 32, MHA
    ]
    worst = 0.0
    for i, (b, sq, skv, h, kv, d, causal, lengths, packed) in enumerate(cases):
        q, k, v, seg = _attn_inputs(b, sq, skv, h, kv, d, seed=i, lengths=lengths,
                                    packed=packed)
        o, lse = flash.flash_attention_fwd(q, k, v, causal=causal, segment_ids=seg)
        o_ref, lse_ref = flash.flash_attention_plain(q, k, v, causal=causal,
                                                     segment_ids=seg)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all()),
                f"flash_fwd case {i}: non-finite output")
        err = float((o.float() - o_ref.float()).abs().max())
        lse_err = float((lse - lse_ref).abs().max())
        torch.testing.assert_close(o.float(), o_ref.float(), atol=O_TOL, rtol=O_TOL)
        torch.testing.assert_close(lse, lse_ref, atol=LSE_TOL, rtol=LSE_TOL)
        worst = max(worst, err)
        log(f"[kernels] flash_fwd B={b} Sq={sq} Skv={skv} H={h} K={kv} D={d} "
            f"causal={causal} seg={'yes' if seg is not None else 'no'}: "
            f"max|o-plain|={err:.3e} max|lse-plain|={lse_err:.3e} ok")
    return {"flash_fwd": worst}


def phase_timings(flash) -> dict:
    import torch
    import torch.nn.functional as F

    out = {}
    shapes = [  # (label, b, s, lengths): the first goes into the kernels line
        ("B=4 S=512", 4, 512, [512, 401, 230, 97]),
        ("B=1 S=512", 1, 512, [401]),
    ]
    for label, b, s, lengths in shapes:
        q, k, v, seg = _attn_inputs(b, s, s, 32, 8, 128, seed=100, lengths=lengths)
        groups = q.shape[2] // k.shape[2]
        # The library call: SDPA over the same function, with the causal and
        # segment mask as one boolean mask and the KV heads expanded (both
        # made outside the timed call).
        mask = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()[None]
        mask = (mask & (seg[:, :, None] == seg[:, None, :]))[:, None]
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(groups, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(groups, dim=2).transpose(1, 2)
        ms = _time_ms(lambda: flash.flash_attention_fwd(q, k, v, causal=True,
                                                        segment_ids=seg))
        plain_ms = _time_ms(lambda: flash.flash_attention_plain(
            q, k, v, causal=True, segment_ids=seg), iters=5)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                 attn_mask=mask))
        ms2 = _time_ms(lambda: flash.flash_attention_fwd(q, k, v, causal=True,
                                                         segment_ids=seg))
        bound_ms, bound_by = _flash_bound(q, k, seg, True)
        log(f"[timing] flash_fwd {label} H=32 K=8 D=128 causal+seg: kernel "
            f"{ms:.4f}/{ms2:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / min(ms, ms2):.1%} of bound")
        out.setdefault("flash_fwd", {
            "ms": min(ms, ms2), "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms,
        })
    return out


def _http(method: str, url: str, payload: dict | None = None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _prefill_logits(gen, cfg, ids: list[int]):
    """The engine's first prefill for one prompt (bucketed, right-padded,
    causal with pad segments, into an empty cache): last-position f32
    logits."""
    import torch

    from ditl_tpu_torch.infer.cache import init_cache
    from ditl_tpu_torch.infer.engine import _next_pow2
    from ditl_tpu_torch.models import llama

    bucket = _next_pow2(len(ids))
    x = torch.full((1, bucket), gen.tokenizer.pad_id, dtype=torch.long, device="cuda")
    x[0, : len(ids)] = torch.tensor(ids, device="cuda")
    pos = torch.arange(bucket, device="cuda")
    seg = (pos < len(ids)).to(torch.int32)[None].contiguous()
    cache = init_cache(cfg, 1, bucket, "cuda")
    hidden = llama.forward(gen.params, x, cfg, positions=pos[None], segment_ids=seg,
                           cache=cache, cache_index=0, prefill_causal=True,
                           return_hidden=True)
    return llama.logits_from_hidden(gen.params, hidden[:, len(ids) - 1])[0]


def phase_serve(flash) -> dict:
    import dataclasses

    import torch

    from ditl_tpu_torch.infer import server as server_mod

    t0 = time.perf_counter()
    server = server_mod.create_server([
        "--preset", "llama3-8b", "--override", "attention_impl=flash",
        "--device", "cuda", "--host", "127.0.0.1", "--port", "0", "--seed", "0",
    ])
    gen = server.RequestHandlerClass.generator
    cfg = gen.cfg
    require((cfg.name, cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
             cfg.vocab_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
             cfg.attention_impl, cfg.dtype)
            == ("llama3-8b", 32, 4096, 14336, 128256, 32, 8, 128, "flash", "bfloat16"),
            cfg)

    def total(tree, fn):
        if isinstance(tree, torch.Tensor):
            return fn(tree)
        return sum(total(sub, fn) for sub in tree.values())

    n_params = total(gen.params, torch.Tensor.numel)
    # A decode step reads every weight once, except the embedding table
    # (one row per token).
    step_bytes = total({k: v for k, v in gen.params.items() if k != "embed"},
                       lambda t: t.numel() * t.element_size())
    torch.cuda.synchronize()
    log(f"[serve] llama3-8b built in {time.perf_counter() - t0:.1f}s: "
        f"{n_params / 1e9:.3f}B parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card; a decode "
        f"step reads {step_bytes / 1e9:.2f} GB of weights: "
        f"{step_bytes / H100_BYTES_PER_S * 1e3:.2f} ms at 3.35 TB/s")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    tok = gen.tokenizer
    chat_msgs = [{"role": "system", "content": _text(1, 60)},
                 {"role": "user", "content": _text(2, 140)}]
    long_prompt = _text(3, 400)
    requests = [  # (route, payload, prompt text as the server builds it)
        ("/v1/completions", {"prompt": _text(0, 100), "max_tokens": 16}, _text(0, 100)),
        ("/v1/chat/completions", {"messages": chat_msgs, "max_tokens": 16},
         server_mod._chat_prompt(chat_msgs)),
        ("/v1/completions", {"prompt": long_prompt, "max_tokens": 24, "logprobs": 1},
         long_prompt),
        ("/v1/completions", {"prompt": long_prompt, "max_tokens": 24, "logprobs": 1},
         long_prompt),
        ("/v1/completions", {"prompt": _text(4, 300), "max_tokens": 16,
                             "temperature": 0.8, "top_p": 0.9, "seed": 7}, _text(4, 300)),
    ]
    from ditl_tpu_torch.infer.engine import _next_pow2

    buckets = [_next_pow2(1 + len(tok.encode(p))) for _, _, p in requests]
    require(min(buckets) >= 128 and 512 in buckets, buckets)

    try:
        flash.reset_launches()  # the main path's count starts here
        status, health = _http("GET", url + "/health")
        require(status == 200 and health["status"] == "ok", health)
        bodies, walls = [], []
        for (route, payload, _), bucket in zip(requests, buckets):
            t = time.perf_counter()
            status, body = _http("POST", url + route, payload)
            wall = time.perf_counter() - t
            walls.append(wall)
            require(status == 200, (route, status, body))
            usage = body["usage"]
            log(f"[serve] {route} bucket {bucket}: {usage['prompt_tokens']} prompt + "
                f"{usage['completion_tokens']} completion tokens in {wall:.3f}s "
                f"(finish {body['choices'][0]['finish_reason']})")
            bodies.append(body)
        launches = {"flash_fwd": flash.launches}  # read right after the run
        status, stats = _http("GET", url + "/v1/stats")
        require(status == 200 and stats["requests"] == len(requests), stats)
    finally:
        server.close(drain=True)
        thread.join(timeout=30)
    require(not thread.is_alive(), "server thread did not stop")

    # Non-empty completions. The byte tokenizer decodes only ids 3..258 of
    # the 128256-way head to text, so with seed-initialised weights the
    # text is mostly empty: non-empty is the token count, and greedy
    # requests ran to their budget (no EOS is likely among 128256 ids).
    for (_, payload, _), body in zip(requests, bodies):
        n = body["usage"]["completion_tokens"]
        require(n >= 1, body)
        if not payload.get("temperature"):
            require(n == payload["max_tokens"], body)
    want = cfg.num_layers * len(requests)  # one prefill per request
    require(launches["flash_fwd"] == want, (launches, want))
    log(f"[serve] flash_fwd launches on the main path: {launches['flash_fwd']} "
        f"= {cfg.num_layers} layers x {len(requests)} prefills")

    # One greedy request repeated gives identical tokens (their logprobs and
    # text agree exactly).
    a, b = (body["choices"][0] for body in bodies[2:4])
    require(a["text"] == b["text"], (a["text"], b["text"]))
    require(a["logprobs"]["token_logprobs"] == b["logprobs"]["token_logprobs"])
    require(a["logprobs"]["tokens"] == b["logprobs"]["tokens"])
    log("[serve] repeated greedy request: identical tokens")

    # The prefill's last-position logits with the flash kernel against the
    # same forward with plain attention, on the card.
    for i in (0, 2):
        ids = [tok.bos_id] + tok.encode(requests[i][2])
        with torch.no_grad():
            torch.cuda.synchronize()
            t = time.perf_counter()
            lf = _prefill_logits(gen, cfg, ids)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t
            lx = _prefill_logits(gen, dataclasses.replace(cfg, attention_impl="xla"), ids)
        log(f"[serve] bucket {buckets[i]}: prefill {prefill_s * 1e3:.1f} ms "
            "(host clock, synchronised)")
        if i == 2:  # its repeat (request 3) ran warm
            steps = requests[3][1]["max_tokens"] - 1  # decode forwards after the prefill
            log(f"[serve] bucket 512, warm request: wall minus prefill over its {steps} "
                f"decode steps {(walls[3] - prefill_s) / steps * 1e3:.1f} ms/step")
        require(lf.shape == (cfg.vocab_size,) and bool(torch.isfinite(lf).all()))
        rel = float((lf - lx).norm() / lx.norm())
        max_err = float((lf - lx).abs().max())
        same_top = int(lf.argmax()) == int(lx.argmax())
        log(f"[serve] prefill logits flash vs xla (bucket {buckets[i]}): rel L2 "
            f"{rel:.3e}, max abs {max_err:.3e} (|logits| max {float(lx.abs().max()):.3f}), "
            f"same argmax {same_top}")
        require(rel <= LOGITS_REL_TOL, rel)
        # The greedy first token the server sampled is this argmax: its
        # logprob is the flash logits' log-softmax maximum.
        if i == 2:
            first_lp = a["logprobs"]["token_logprobs"][0]
            want_lp = float(torch.log_softmax(lf, -1).max())
            require(abs(first_lp - want_lp) < 1e-4, (first_lp, want_lp))
    log(f"[serve] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 1
    from ditl_tpu_torch.ops import flash_attention as flash

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_card()
    phase_build()
    errors = phase_kernels(flash)
    timings = phase_timings(flash)
    launches = phase_serve(flash)
    kernels = []
    for name, meta in KERNELS.items():
        if launches.get(name, 0) < 1:
            raise AssertionError(f"kernel {name} was not launched on the main path")
        kernels.append({"name": name, **meta, "launches": launches[name],
                        "max_abs_err": errors[name], **timings[name]})
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

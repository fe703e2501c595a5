"""Where one training step's time goes on the card.

    python -m ditl_tpu_torch.tools.profile_train [--path 3|9|10|13] [section.field=value ...]

Starts from one of ``chip_smoke.py``'s training paths (``PATH_ARGS``:
``--path 3``, the default, ``llama3-8b`` at full width and depth in bf16;
``--path 9``, ``qwen2-0.5b`` at its published size in f32, the MLP and
projection backward at the "xla" defaults; ``--path 10``, path 9 under the
reference's kernel flags and the block fields that admit its widths: K5a-f32,
K5b-f32 and K6-f32; ``--path 13``, path 10 in float16 compute over f32
masters: K1-f16, K2a-f16, K2b-f16, K5a-f16, K5b-f16 and K6-f16; all B=4,
S=2048) and applies the launcher's arguments
given on the command line on top of it, so that, for example,

    python -m ditl_tpu_torch.tools.profile_train model.fused_gate_up=true \
        model.mlp_bwd_impl=pallas model.proj_bwd_impl=pallas

breaks down a step of training path 4 (the MLP and projection backward
kernels), and with ``model.remat=dots_inputs`` added, of path 5 (the JAX
package's one-chip recipe). The remat policy is the arguments' (the
config's default, ``full``, when none is given). It builds the train state,
runs ``--warmup`` steps, then:

1. times ``--steps`` steps with the host clock after ``synchronize``, split
   into forward + backward and the optimizer (global norm, clip, update);
2. traces ``--steps`` more steps with ``torch.profiler`` and sums the
   device time of every kernel by category (each of the port's kernels,
   bf16, float16 and f32, in a category of its own; then GEMMs and the
   rest),
   against the traced wall time: the device's idle share is what the
   kernels leave of it.

Prints one JSON object as its last line. Needs the card; it does not fall
back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time

import torch

__all__ = ["main"]

_BF16_ARGS = [
    "--preset", "llama3-8b", "model.param_dtype=bfloat16", "model.attention_impl=flash",
    "model.loss_impl=fused", "model.loss_block_tokens=4096", "train.optimizer=adafactor",
    "train.warmup_steps=1", "train.total_steps=20",
    "data.synthetic=true", "data.batch_size=4", "data.seq_len=2048",
]
_F32_ARGS = [
    "--preset", "qwen2-0.5b", "model.dtype=float32", "model.param_dtype=float32",
    "model.attention_impl=flash", "model.loss_impl=fused", "model.loss_block_tokens=4096",
    "model.remat=full", "train.optimizer=adafactor", "train.warmup_steps=1",
    "train.total_steps=20", "data.synthetic=true", "data.batch_size=4", "data.seq_len=2048",
]
# qwen2-0.5b's widths (D = 896, F = 4864) take the kernels only with these
# two of the reference's block fields (ops/mlp_bwd.py::supports,
# ops/projection.py::supports).
_KERNEL_FLAGS = ["model.fused_gate_up=true", "model.mlp_bwd_impl=pallas",
                 "model.proj_bwd_impl=pallas", "model.mlp_bwd_block_f=256",
                 "model.proj_bwd_block_d=128"]
PATH_ARGS = {
    "3": _BF16_ARGS,
    "9": _F32_ARGS,
    "10": _F32_ARGS + _KERNEL_FLAGS,
    "13": [a.replace("model.dtype=float32", "model.dtype=float16") for a in _F32_ARGS]
    + _KERNEL_FLAGS,
}
# A float16 instance of a bf16 kernel template: its trace name carries the
# element-type argument, demangled ("<64, true>", "<true>") or mangled
# ("ILi64ELb1EE", "ILb1EE"; names are matched lower-cased).
_F16 = r"(<(\d+, )?true>|i(li\d+e)?lb1e)"
# (category, regular expressions searched in kernel names), first match
# wins. Every __global__ kernel of ditl_tpu_torch/csrc/*.cu has a category of
# its own, ahead of "GEMM" (whose patterns a kernel's name could contain).
CATEGORIES = (
    ("K1-f16 flash_fwd_f16", ("flash_fwd_kernel" + _F16,)),
    ("K2a-f16 flash_dq_f16", ("flash_bwd_dq_kernel" + _F16,)),
    ("K2b-f16 flash_dkv_f16", ("flash_bwd_dkv_kernel" + _F16,)),
    ("K5a-f16 mlp_dgu_dwdown_f16", ("mlp_dgu_dwdown_kernel" + _F16,)),
    ("K5b-f16 mlp_dh_dwgu_f16", ("proj_bwd_kernel<5, true>", "proj_bwd_kernelili5elb1e")),
    ("K6-f16 proj_bwd_f16", ("proj_bwd_kernel<6, true>", "proj_bwd_kernelili6elb1e")),
    ("K1 flash_fwd", ("flash_fwd_kernel",)),
    ("K2a flash_dq", ("flash_bwd_dq_kernel",)),
    ("K2b flash_dkv", ("flash_bwd_dkv_kernel",)),
    ("K1-f32 flash_fwd_f32", ("flash_fwd_f32_kernel",)),
    ("K2a-f32 flash_dq_f32", ("flash_dq_f32_kernel",)),
    # K2b-f32's runs and, when it splits, their in-order sum
    ("K2b-f32 flash_dkv_f32", ("flash_dkv_f32_kernel", "flash_dkv_f32_sum_kernel")),
    # the row-tile kernel: every verify in bf16 and float16, and K3, K3-int8
    # and K4 past 8 query rows a KV head
    ("K3-verify/K3-int8-verify/K3 and K4 past 8 rows paged_rows", ("paged_rows_kernel",)),
    ("K3/K4 paged_split", ("paged_split_kernel",)),
    ("K3/K4 paged_merge", ("paged_merge_kernel",)),
    # the tensor-core kernel: every f32 paged form (K3-f32, its verify,
    # K4-f32, K3-int8-f32 and its verify)
    ("K3-f32/K3-f32-verify/K4-f32/K3-int8-f32/K3-int8-f32-verify paged_mma_f32",
     ("paged_mma_f32_kernel",)),
    ("K3/K4-f32 paged_merge_f32", ("paged_merge_f32_kernel",)),
    ("K5a mlp_dgu_dwdown", ("mlp_dgu_dwdown_kernel",)),
    # K5b and K6 are instances of one kernel, tagged 5 and 6 (demangled or
    # mangled; names are matched lower-cased)
    ("K5b mlp_dh_dwgu", ("proj_bwd_kernel<5[,>]", "proj_bwd_kernelili5e")),
    ("K6 proj_bwd", ("proj_bwd_kernel<6[,>]", "proj_bwd_kernelili6e")),
    ("K5 GEMM core alone (card tests)", ("gemm_sm90_kernel",)),
    ("K5a-f32 mlp_dgu_f32", ("mlp_dgu_f32_kernel",)),
    # K5b-f32 and K6-f32 are instances of one kernel, tagged 5 and 6; a
    # spelling without the tag (no trace gives one) files as K6-f32's
    ("K5b-f32 mlp_dh_f32", ("grad_pair_f32_kernel<5>", "grad_pair_f32_kernelili5e")),
    ("K6-f32 proj_bwd_f32", ("grad_pair_f32_kernel",)),
    ("K5/K6-f32 split sums", ("splitk_sum_f32_kernel",)),
    ("GEMM", ("gemm", "xmma", "cutlass", "cublas", "nvjet", "sm90_")),
    ("elementwise/reduce", ("elementwise", "reduce", "vectorized", "unrolled",
                            "index", "scatter", "gather", "softmax", "cat", "copy",
                            "fill", "where", "pow", "norm")),
)


def _category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(re.search(k, low) for k in keys):
            return cat
    return "other"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="ditl_tpu_torch.tools.profile_train")
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--path", choices=sorted(PATH_ARGS), default="3",
                        help="the training path whose arguments come first")
    args, rest = parser.parse_known_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: needs a CUDA device", file=sys.stderr)
        return 1
    from ditl_tpu_torch.data.dataset import load_text_dataset
    from ditl_tpu_torch.data.loader import DataPipeline
    from ditl_tpu_torch.data.tokenizer import get_tokenizer
    from ditl_tpu_torch.launch import build_config
    from ditl_tpu_torch.models import llama
    from ditl_tpu_torch.train.state import TrainState, global_norm, make_optimizer
    from ditl_tpu_torch.train.step import cast_for_compute, loss_fn, train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    config, device = build_config(PATH_ARGS[args.path] + rest)
    cfg = config.model
    pipe = DataPipeline(load_text_dataset(config.data), get_tokenizer(config.data.tokenizer),
                        config.data, device)
    batches = iter(pipe)
    params = llama.init_train_params(cfg, seed=config.train.seed, device=device)
    opt = make_optimizer(config.train, params)
    state = TrainState.create(params, opt)
    for _ in range(args.warmup):
        train_step(state, next(batches), cfg, opt)
    torch.cuda.synchronize()

    # 1. Host clock around each phase, synchronised.
    fb, upd = [], []
    cast = cast_for_compute(cfg)
    for _ in range(args.steps):
        batch = next(batches)
        t0 = time.perf_counter()
        layers, top = state.model_views(cast)
        loss, _ = loss_fn(layers, top, batch, cfg)
        loss.backward()
        del layers, top, loss
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            global_norm(state.leaves)
            opt.step(state.leaves, state.opt_state)
            for leaf in state.leaves:
                for p in leaf.parts:
                    p.grad = None
        torch.cuda.synchronize()
        fb.append(t1 - t0)
        upd.append(time.perf_counter() - t1)

    # 2. Kernel time by category under torch.profiler.
    from torch.profiler import ProfilerActivity, profile

    steps = [next(batches) for _ in range(args.steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in steps:
            train_step(state, batch, cfg, opt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_cat: dict[str, float] = {}
    top: list[tuple[float, str, int]] = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3 / args.steps  # us -> ms per step
        if ms <= 0:
            continue
        by_cat[_category(evt.key)] = by_cat.get(_category(evt.key), 0.0) + ms
        top.append((ms, evt.key, evt.count // args.steps))
    busy = sum(by_cat.values())
    step_ms = wall / args.steps * 1e3
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi)
    print(f"phases (host clock, synchronised): forward+backward "
          f"{[round(x, 4) for x in fb]} s, optimizer {[round(x, 4) for x in upd]} s")
    print(f"traced: {step_ms:.1f} ms per step, kernels {busy:.1f} ms per step, "
          f"device idle {1 - busy / step_ms:.1%}")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:20s} {ms:9.2f} ms per step ({ms / step_ms:.1%} of the step)")
    for ms, name, n in sorted(top, reverse=True)[:25]:
        print(f"  {ms:9.3f} ms  x{n:<5d} {name[:110]}")
    print(json.dumps({
        "device": smi, "config": {"path": args.path, "model": cfg.name,
                                  "dtype": cfg.dtype, "layers": cfg.num_layers,
                                  "remat": cfg.remat,
                                  "batch": config.data.batch_size,
                                  "seq": config.data.seq_len, "overrides": rest},
        "forward_backward_s": fb, "optimizer_s": upd, "traced_step_ms": step_ms,
        "kernel_ms_per_step": by_cat, "device_idle_share": 1 - busy / step_ms,
        "peak_device_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

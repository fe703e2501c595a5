"""The training profile's kernel categories (``tools/profile_train.py``).

``_category`` files each kernel of a ``torch.profiler`` trace by substrings
of its name. Every ``__global__`` kernel of the port's CUDA sources
(``ditl_tpu_torch/csrc/*.cu``) must land in a category of the port's own,
never in cuBLAS's "GEMM" (a port kernel's name may contain ``gemm``) or in
"other", whether the trace names it demangled (with or without template
arguments) or mangled. The names are read from the sources themselves, so
a new kernel without a category fails here.
"""

import dataclasses
import re

import pytest

torch = pytest.importorskip("torch")

from ditl_tpu_torch.ops.cuda_build import CSRC  # noqa: E402
from ditl_tpu_torch.tools import profile_train  # noqa: E402

torch.set_num_threads(1)

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
PORT_CATEGORIES = {cat for cat, _ in profile_train.CATEGORIES} - {"GEMM", "elementwise/reduce"}


def _kernels() -> list[tuple[str, str]]:
    return sorted((src.name, name) for src in CSRC.glob("*.cu")
                  for name in _GLOBAL.findall(src.read_text()))


def test_every_source_declares_kernels():
    """The regex finds the kernels of every source (the bf16 and f32 flash
    and paged kernels, K2b-f32's split sum, K5a and the GEMM core, the f32
    MLP and projection kernels and their split sum)."""
    found = _kernels()
    assert {src for src, _ in found} == {p.name for p in CSRC.glob("*.cu")} - {
        "projection_bwd.cu"}  # K6's body is gemm_sm90.cuh's proj_bwd_kernel<6>
    names = {name for _, name in found}
    assert {"flash_fwd_f32_kernel", "flash_dq_f32_kernel", "flash_dkv_f32_kernel",
            "paged_mma_f32_kernel", "paged_merge_f32_kernel",
            "mlp_dgu_f32_kernel",
            "grad_pair_f32_kernel", "splitk_sum_f32_kernel",
            "flash_dkv_f32_sum_kernel", "paged_rows_kernel", "paged_split_kernel"} <= names


@pytest.mark.parametrize("src,name", _kernels())
def test_every_port_kernel_has_a_port_category(src, name):
    """Each kernel, as the trace may name it: plain, demangled with template
    arguments and its anonymous namespace, and mangled (lower-cased by
    ``_category``), lands in one port category, the same each way."""
    spellings = [name, f"void (anonymous namespace)::{name}<64>((anonymous namespace)::Params)",
                 f"_ZN44_GLOBAL__N__653f8060_11_{src.replace('.', '_')}_854ed9c0"
                 f"{len(name)}{name}ENS_6ParamsE"]
    cats = {profile_train._category(x) for x in spellings}
    assert len(cats) == 1 and cats <= PORT_CATEGORIES, (src, name, cats)


def test_row_tile_kernel_has_a_category_of_its_own():
    """The row-tile paged kernel (the verify, and the single query past 8
    rows a KV head) is not filed with the single-query split kernel."""
    rows = profile_train._category("void (anonymous namespace)::paged_rows_kernel<128, true, "
                                   "false, false, 2>((anonymous namespace)::Params)")
    assert rows != profile_train._category("paged_split_kernel")
    assert rows in PORT_CATEGORIES and "paged_rows" in rows


def test_f32_kernels_have_categories_of_their_own():
    """The f32 kernels are not filed with their bf16 counterparts: K1-f32,
    K2a-f32, K2b-f32, K3/K4-f32 (every f32 paged form on the tensor-core
    kernel) and K5a/K5b/K6-f32 each have their own."""
    pairs = [("flash_fwd_kernel", "flash_fwd_f32_kernel"),
             ("flash_bwd_dq_kernel", "flash_dq_f32_kernel"),
             ("flash_bwd_dkv_kernel", "flash_dkv_f32_kernel"),
             ("paged_split_kernel", "paged_mma_f32_kernel"),
             ("paged_merge_kernel", "paged_merge_f32_kernel"),
             ("mlp_dgu_dwdown_kernel", "mlp_dgu_f32_kernel"),
             ("proj_bwd_kernel<5>", "grad_pair_f32_kernel<5>"),
             ("proj_bwd_kernel<6>", "grad_pair_f32_kernel<6>")]
    for bf16, f32 in pairs:
        assert profile_train._category(bf16) != profile_train._category(f32), (bf16, f32)
    cats = [profile_train._category(f32) for _, f32 in pairs]
    assert len(set(cats)) == len(cats)


@pytest.mark.parametrize("tag,cat", [(5, "K5b-f32 mlp_dh_f32"), (6, "K6-f32 proj_bwd_f32")])
def test_f32_grad_pair_instances_have_their_users_categories(tag, cat):
    """K5b-f32 and K6-f32 are two instances of one kernel,
    ``grad_pair_f32_kernel<5>`` and ``<6>`` (csrc/gemm_f32.cu): each lands in
    its user's category, demangled or mangled."""
    kernel = "grad_pair_f32_kernel"
    names = (f"void (anonymous namespace)::{kernel}<{tag}>((anonymous namespace)::Params)",
             f"_ZN12_GLOBAL__N_1{len(kernel)}{kernel}ILi{tag}EEEvNS_6ParamsE")
    assert {profile_train._category(x) for x in names} == {cat}


@pytest.mark.parametrize("name,cat", [
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x128_8x4_nn_align1>(Params)", "GEMM"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32", "GEMM"),
    ("void at::native::vectorized_elementwise_kernel<4, AddFunctor<float>>", "elementwise/reduce"),
])
def test_library_kernels_keep_their_categories(name, cat):
    """cuBLAS's and PyTorch's own kernels still land where they did."""
    assert profile_train._category(name) == cat


@pytest.mark.parametrize("kernel,template", [
    ("flash_fwd_kernel", "64"), ("flash_bwd_dq_kernel", "128"), ("flash_bwd_dkv_kernel", "32"),
    ("mlp_dgu_dwdown_kernel", ""), ("proj_bwd_kernel", "5"), ("proj_bwd_kernel", "6")])
def test_float16_instances_have_categories_of_their_own(kernel, template):
    """The float16 instances of the bf16 templates (K1-f16, K2a-f16,
    K2b-f16, K5a-f16, K5b-f16, K6-f16) land in a category of their own, not
    their bf16 twin's, demangled or mangled."""
    def spellings(flag):
        args = f"{template}, {flag}" if template else flag
        mangled = (f"ILi{template}ELb{int(flag == 'true')}EE" if template
                   else f"ILb{int(flag == 'true')}EE")
        return {profile_train._category(f"void (anonymous namespace)::{kernel}<{args}>(x)"),
                profile_train._category(f"_ZN12_GLOBAL__N_1{len(kernel)}{kernel}{mangled}Ev")}

    f16, bf16 = spellings("true"), spellings("false")
    assert len(f16) == len(bf16) == 1 and f16 != bf16, (f16, bf16)
    assert f16 <= PORT_CATEGORIES and bf16 <= PORT_CATEGORIES
    assert "-f16 " in next(iter(f16)) and "-f16" not in next(iter(bf16))


def test_path_arguments():
    """``--path`` picks the arguments of training paths 3, 9, 10 and 13;
    path 10 is path 9 under the kernel flags with the block fields that
    admit qwen2-0.5b's widths, path 13 path 10 in float16 compute over f32
    masters."""
    from ditl_tpu_torch.launch import build_config

    args = profile_train.PATH_ARGS
    assert args["10"][:len(args["9"])] == args["9"]
    cfgs = {p: build_config(a + ["--device", "cpu"])[0].model for p, a in args.items()}
    assert (cfgs["3"].name, cfgs["3"].param_dtype) == ("llama3-8b", "bfloat16")
    assert (cfgs["9"].name, cfgs["9"].dtype, cfgs["9"].mlp_bwd_impl) == (
        "qwen2-0.5b", "float32", "xla")
    c = cfgs["10"]
    assert (c.fused_gate_up, c.mlp_bwd_impl, c.proj_bwd_impl, c.mlp_bwd_block_f,
            c.proj_bwd_block_d) == (True, "pallas", "pallas", 256, 128)
    c13 = cfgs["13"]
    assert (c13.dtype, c13.param_dtype) == ("float16", "float32")
    assert dataclasses.replace(c13, dtype="float32") == c

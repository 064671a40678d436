"""The bank read kernels' build key and the profile's kernel groups, on the
CPU (no nvcc is needed: nothing is compiled here)."""

import importlib.util
import os

import pytest

from vfloodnet_tpu_torch.ops import bank_read_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_library_name_hashes_every_source_and_header(tmp_path, monkeypatch):
    monkeypatch.setattr(bank_read_cuda, "CSRC", str(tmp_path))
    (tmp_path / "bank_read.cu").write_text("// kernels\n")
    first = bank_read_cuda.library_path()
    assert first == bank_read_cuda.library_path()   # stable
    (tmp_path / "tiles.cuh").write_text("// a header\n")
    with_header = bank_read_cuda.library_path()
    assert with_header != first
    (tmp_path / "tiles.cuh").write_text("// an edited header\n")
    assert bank_read_cuda.library_path() not in (first, with_header)
    (tmp_path / "notes.txt").write_text("not read by the build\n")
    (tmp_path / "tiles.cuh").write_text("// an edited header\n")
    assert bank_read_cuda.library_path() == bank_read_cuda.library_path()


def test_the_package_sources_are_hashed():
    names = [os.path.basename(p) for p in bank_read_cuda._csrc_files()]
    assert {"bank_read.cu", "bank_read_bf16.cu", "bank_common.cuh"} <= \
        set(names)
    assert set(bank_read_cuda.SOURCES.values()) <= set(names)


@pytest.fixture(scope="module")
def profile():
    spec = importlib.util.spec_from_file_location(
        "profile_torch_step", os.path.join(ROOT, "scripts",
                                           "profile_torch_step.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,group", [
    ("(anonymous namespace)::read_kernel(float const*, float const*, "
     "float const*, unsigned char const*, int const*, float*, float*, "
     "float*, int, int, int, int, float)", "bank_read_kernel"),
    ("(anonymous namespace)::combine_kernel(float const*, float const*, "
     "float const*, float*, float*, float*, float*, int, int, float)",
     "bank_read_kernel"),
    ("_ZN12_GLOBAL__N_114combine_kernelEPKfS1_S1_PfS2_S2_S2_iif",
     "bank_read_kernel"),
    ("(anonymous namespace)::count_kernel(float const*, float const*, "
     "unsigned char const*, int const*, float const*, float*, int, int, "
     "int, float)", "bank_count_kernel"),
    ("(anonymous namespace)::read_bf16_kernel(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, unsigned char const*, "
     "int const*, float*, float*, float*, int, int, int, int, float)",
     "bank_read_kernel"),
    ("(anonymous namespace)::count_bf16_kernel(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, unsigned char const*, int const*, float const*, "
     "float*, int, int, int, float)", "bank_count_kernel"),
    ("void at::native::elementwise_kernel<128, 2, thread_kernel>(int)",
     "other"),
    ("ampere_sgemm_128x64_nn", "gemm"),
])
def test_profile_groups_the_bank_kernels(profile, name, group):
    assert profile._group(name) == group

"""The kernel build's cache key, on the CPU (nothing is compiled here).

A library is rebuilt when its key changes, so the key must change with
every source it compiles and every header those sources may include.
"""
from repro_torch.kernels import build


def _csrc(tmp_path, header="// helpers v1\n"):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text(header)
    return tmp_path


def test_key_changes_with_an_included_header(tmp_path):
    before = build.library_path("k", ["k.cu"], _csrc(tmp_path))
    after = build.library_path("k", ["k.cu"], _csrc(tmp_path, "// helpers v2\n"))
    assert before != after
    assert build.library_path("k", ["k.cu"], tmp_path) == after  # same inputs, same key


def test_key_changes_with_a_source_and_names_the_library(tmp_path):
    csrc = _csrc(tmp_path)
    before = build.library_path("k", ["k.cu"], csrc)
    (csrc / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    after = build.library_path("k", ["k.cu"], csrc)
    assert before != after
    assert after.parent == build.BUILD_DIR and after.name.startswith("k-")
    assert after.suffix == ".so"


def test_key_changes_with_a_library_s_own_flags(tmp_path):
    csrc = _csrc(tmp_path)
    plain = build.library_path("k", ["k.cu"], csrc)
    strict = build.library_path("k", ["k.cu"], csrc, extra_flags=("--fmad=false",))
    assert plain != strict
    assert strict == build.library_path("k", ["k.cu"], csrc, extra_flags=("--fmad=false",))


def test_shipped_sources_have_their_headers():
    """Every kernel source in the package, and the header the wgmma kernels
    share, enters the key of the shipped libraries; the fp64 engine kernels
    build without multiply-add contraction."""
    from repro_torch.kernels.spray_sim import kernel as sim_kernel
    from repro_torch.kernels.tent_core import kernel as tc_kernel

    assert (build.CSRC / "wgmma.cuh").exists()
    for name in ("flash_attention", "ssd_scan", "kv_pack", "tent_core", "spray_sim", "ssm_step"):
        assert build.library_path(name, [f"{name}.cu"]).name.startswith(f"{name}-")
    assert tc_kernel.EXTRA_FLAGS == sim_kernel.EXTRA_FLAGS == ("--fmad=false",)

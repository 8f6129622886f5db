"""The kernel build's cache key, on the CPU (no nvcc needed).

``ops/kernels/build.py`` names each library by a hash of its source, the
``csrc/`` headers the source includes and the nvcc flags. An edit to a
shared header must give each kernel that includes it a new library, for
either storage type (a stale one would run the old code), and leave the
other kernels' libraries as they are: the cluster layer that kernels K2
(with its tensor-parallel blocks) and K3 share, the constants and LayerNorm
it includes (which the beam search's routines use too), and the beam
search's routines that K3 and K5 share. The module imports no torch, so
these run in the pytest process.
"""

from __future__ import annotations

import shutil

import pytest

from khmer_ocr_torch.ops.kernels import build

# K2, its tensor-parallel blocks and K3, each built once per storage type (float, bf16), and K2's second float
# build, bounded for two CTAs an SM
CLUSTER_USERS = ("decoder_layer_step", "decoder_layer_step_bf16", "decoder_layer_step_two_ctas", "decoder_block",
                 "decoder_block_bf16", "decode_loop", "decode_loop_bf16")
# each shared header -> the libraries built from it
USERS = {
    "decoder_common.cuh": (*CLUSTER_USERS, "beam_step", "decoder_layer_card"),
    "decoder_cluster.cuh": CLUSTER_USERS,
    "beam_search.cuh": ("decode_loop", "decode_loop_bf16", "beam_step"),
}
SHARED = tuple(USERS)


@pytest.mark.parametrize("name", sorted(build.SOURCES))
def test_source_and_its_headers(name):
    files = [f.name for f in build.source_files(name)]
    assert files[0] == build.SOURCES[name] and all((build.CSRC_DIR / f).exists() for f in files)
    for header in SHARED:
        assert (header in files) == (name in USERS[header])


@pytest.mark.parametrize("header", SHARED)
def test_header_edit_rebuilds_exactly_its_users(tmp_path, monkeypatch, header):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    before = {name: build.library_path(name) for name in build.SOURCES}
    (csrc / header).write_text((csrc / header).read_text() + "\n// edited\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    assert {name for name in build.SOURCES if before[name] != after[name]} == set(USERS[header])


@pytest.mark.parametrize("dtype,two_ctas,name,flags", [
    ("torch.float32", False, "decoder_layer_step", ()),
    ("torch.float32", True, "decoder_layer_step_two_ctas", ("-DK2_F32_MIN_BLOCKS=2",)),
    ("torch.bfloat16", False, "decoder_layer_step_bf16", ("-DSTORAGE_BF16",)),
    ("torch.bfloat16", True, "decoder_layer_step_bf16", ("-DSTORAGE_BF16",)),
])
def test_k2_library_by_storage_type_and_ctas_an_sm(dtype, two_ctas, name, flags):
    """K2's float launches take the library bounded for one CTA an SM or,
    when asked, two; bf16 has one library (one CTA an SM)."""
    assert build.library_name("decoder_layer_step", dtype, two_ctas=two_ctas) == name
    assert build.extra_flags(name) == flags and build.SOURCES[name] == "decoder_layer_step.cu"

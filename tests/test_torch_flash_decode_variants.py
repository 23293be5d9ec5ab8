"""The measured variants of the flash_decode kernel
(``repro_torch.launch.flash_decode_variants``) still apply to its source:
each replaced text occurs in ``csrc/flash_decode.cu`` exactly once, so an
edit of the kernel that would leave a variant measuring the wrong thing
fails here, on the CPU, before any card run."""

import pytest

from repro_torch.launch import flash_decode_variants as FV


@pytest.mark.parametrize("name", sorted(FV.VARIANTS))
def test_variant_applies_to_the_kernel_source(name):
    src = FV.variant_source(name)
    edits = FV.VARIANTS[name][1]
    for old, new in edits:
        assert new in src
    if edits:
        assert src != FV.variant_source("shipped")
    assert "lamp_flash_decode_workspace" in src and "cp_async8" in src

"""The measured variants of the lamp_flash_attention kernel
(``repro_torch.launch.lamp_attention_variants``) still apply to its
source: each replaced text occurs in ``csrc/lamp_attention.cu`` exactly
once, so an edit of the kernel that would leave a variant measuring the
wrong thing fails here, on the CPU, before any card run."""

import pytest

from repro_torch.launch import lamp_attention_variants as LV


@pytest.mark.parametrize("name", sorted(LV.VARIANTS))
def test_variant_applies_to_the_kernel_source(name):
    src = LV.variant_source(name)
    edits = LV.VARIANTS[name][1]
    for old, new in edits:
        assert new in src
    if edits:
        assert src != LV.variant_source("shipped")
    assert "lamp_flash_attention_smem" in src

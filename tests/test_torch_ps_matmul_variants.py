"""The measured variants of the ps_matmul kernel
(``repro_torch.launch.ps_matmul_variants``) still apply to its source:
each replaced text occurs in ``csrc/ps_matmul.cu`` exactly once, so an
edit of the kernel that would leave a variant measuring the wrong thing
fails here, on the CPU, before any card run."""

import pytest

from repro_torch.launch import ps_matmul_variants as PV


@pytest.mark.parametrize("name", sorted(PV.VARIANTS))
def test_variant_applies_to_the_kernel_source(name):
    src = PV.variant_source(name)
    edits = PV.VARIANTS[name][1]
    for old, new in edits:
        assert new in src
    if edits:
        assert src != PV.variant_source("shipped")
    assert "lamp_ps_matmul" in src

"""The measured variants of the rmsnorm kernel
(``repro_torch.launch.rmsnorm_variants``) still apply to its source: each
replaced text occurs in ``csrc/rmsnorm.cu`` exactly once, so an edit of the
kernel that would leave a variant measuring the wrong thing fails here, on
the CPU, before any card run."""

import pytest

from repro_torch.launch import rmsnorm_variants as RV


@pytest.mark.parametrize("name", sorted(RV.VARIANTS))
def test_variant_applies_to_the_kernel_source(name):
    src = RV.variant_source(name)
    edits = RV.VARIANTS[name][1]
    for old, new in edits:
        assert new in src
    if edits:
        assert src != RV.variant_source("shipped")
    assert "lamp_rmsnorm_vector_path" in src

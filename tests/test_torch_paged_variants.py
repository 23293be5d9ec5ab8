"""The measured variants of the paged attention kernel
(``repro_torch.launch.paged_attention_variants``) still apply to its
source: each replaced text occurs in ``csrc/paged_attention.cu`` exactly
once, so an edit of the kernel that would leave a variant measuring the
wrong thing fails here, on the CPU, before any card run."""

import pytest

from repro_torch.launch import paged_attention_variants as PV


@pytest.mark.parametrize("name", sorted(PV.VARIANTS))
def test_variant_applies_to_the_kernel_source(name):
    src = PV.variant_source(name)
    edits = PV.VARIANTS[name][1]
    for old, new in edits:
        assert new in src and old not in src
    if edits:
        assert src != PV.variant_source("shipped")
    assert "lamp_paged_mixed_attention" in src and "cp_async16" in src


def test_buckets_mirror_the_engine():
    """The five buckets: 8 decode rows at width 1, 8 verify rows of width
    5 and 2 rows at width 8, prefill windows at width 128, the draft's 8
    decode rows."""
    kinds = {n: (k, len(s), w) for n, (k, s, _, w) in PV.BUCKETS.items()}
    assert kinds == {"mixed_8x1": ("mixed", 8, 1), "mixed_8x8": ("mixed", 8, 8),
                     "mixed_2x8": ("mixed", 2, 8), "mixed_8x128": ("mixed", 8, 128),
                     "draft_8": ("decode", 8, 1)}
    assert PV.BUCKETS["mixed_8x8"][2] == [5] * 8

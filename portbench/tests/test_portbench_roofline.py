"""The frozen roofline counts give kernel #1's bound of the kernel table."""

from _util import ROOT  # noqa: F401
from portbench.roofline import counts


def test_stage_bound_at_the_headline_shape():
    nfd, m_p, m_blk, bs = counts.stage_shapes(10, 10)
    assert (nfd, m_p, m_blk, bs) == (135, 512, 9, 15)
    flops = counts.stage_flops(6144, nfd, m_p, m_blk, bs, 48)
    ms, by = counts.roofline_ms(flops, counts.stage_bytes(6144, nfd, m_p,
                                                          m_blk, bs))
    assert by == "operations"
    assert round(ms, 4) == 1.7705

"""The launch plan of the confusion-matrix kernel (K2,
rtseg_tpu_torch/ops/pallas_metrics.py::k2_plan), held on the CPU: the
kernel itself runs only on the card (chip_smoke.py holds it to its plain
version there).

The plan cuts n pixels into a scalar head, per-block chunks of 16-byte
vectors and a scalar tail; the ranges the kernel counts under a plan
(`plan_ranges`, the kernel's indexing) must cover [0, n) once, and the
shared memory it asks for must fit a block for every class count the
kernel takes.
"""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from rtseg_tpu_torch.ops.pallas_metrics import (_THREADS, _VECS, K2Plan,
                                                k2_plan)

H100 = dict(sms=132, smem_block=232448, smem_sm=233472)
FULL = 16 * 1024 * 2048          # the eval batch at 1024x2048


def plan_ranges(plan: K2Plan):
    """The pixel ranges [start, stop) confusion_matrix.cu counts under
    `plan`, in the order of its indexing: the head (block 0's first
    lanes), block b's vectors [b * chunk, min((b + 1) * chunk, nvec)) of
    the body, the tail (empty ranges left out)."""
    body = plan.head + 4 * plan.nvec
    ranges = [(0, plan.head)]
    for b in range(plan.grid):
        start = min(b * plan.chunk, plan.nvec)
        stop = min(start + plan.chunk, plan.nvec)
        ranges.append((plan.head + 4 * start, plan.head + 4 * stop))
    ranges.append((body, body + plan.tail))
    return [r for r in ranges if r[1] > r[0]]


def _plan(n, lo=0, po=0, C=19, **card):
    return k2_plan(n, lo, po, C, **{**H100, **card})


def _assert_covers(plan: K2Plan, n: int, lo: int, po: int):
    ranges = plan_ranges(plan)
    pos = 0
    for start, stop in ranges:
        assert start == pos and stop > start
        pos = stop
    assert pos == n
    assert plan.head + 4 * plan.nvec + plan.tail == n
    assert 0 <= plan.head < 4 and 0 <= plan.tail < 4
    assert plan.vec == (lo % 4 == po % 4)
    if plan.vec:
        # the body starts on a 16-byte boundary of both maps
        assert (lo + plan.head) % 4 == 0 or plan.nvec == 0
    else:
        assert plan.head == 0
    if plan.nvec:
        # every block has work, and the chunks start 512 bytes apart
        assert (plan.grid - 1) * plan.chunk < plan.nvec <= \
            plan.grid * plan.chunk
        assert plan.chunk % 32 == 0
    assert 1 <= plan.grid <= 2 * H100['sms']


SIZES = (0, 1, 2, 3, 4, 5, 6, 7, 8, 31, 127, 1000, _THREADS * _VECS * 4 - 1,
         _THREADS * _VECS * 4 * 264 + 13, 16 * 512 * 1024 - 7, FULL,
         FULL + 3)


@pytest.mark.parametrize('lo', range(4))
@pytest.mark.parametrize('po', range(4))
def test_plan_ranges_cover_each_pixel_once(lo, po):
    for n in SIZES:
        _assert_covers(_plan(n, lo, po), n, lo, po)


@settings(max_examples=300, deadline=None)
@given(n=st.integers(0, 5_000_000), lo=st.integers(0, 3),
       po=st.integers(0, 3), sms=st.sampled_from([1, 7, 114, 132]),
       C=st.integers(1, 241))
def test_plan_ranges_cover_each_pixel_once_any_size(n, lo, po, sms, C):
    plan = _plan(n, lo, po, C, sms=sms)
    _assert_covers(plan, n, lo, po)
    assert plan.grid <= 2 * sms


def test_plan_shared_memory_fits_every_class_count():
    for C in range(1, 242):
        plan = _plan(FULL, C=C)
        # one whole histogram a block, within a block's opt-in
        assert plan.smem == C * C * 4 <= H100['smem_block']
        if plan.grid > H100['sms']:
            # two blocks an SM: both, with their reserve, fit the SM
            assert 2 * (plan.smem + 1024) <= H100['smem_sm']


def test_plan_blocks_an_sm_for_the_street_classes():
    # C=19: two blocks an SM; the largest C one block an SM, and the
    # largest C with two
    assert _plan(FULL).grid == 264
    assert _plan(FULL, C=241).grid == 132
    assert _plan(FULL, C=170).grid == 264 and _plan(FULL, C=171).grid == 132


@pytest.mark.parametrize('C', [0, 242, 300])
def test_plan_refuses_a_histogram_that_does_not_fit(C):
    with pytest.raises(ValueError, match='does not fit'):
        _plan(FULL, C=C)

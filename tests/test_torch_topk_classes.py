"""The per-class top-k of the reference postprocess on the softmax output as
it lies: K3 (demonet_tpu_torch.ops.topk) on the (B, C-1, A) view
`scores[..., 1:].transpose(1, 2)` of the (B, A, C) scores, never copied.

On the CPU the op runs its plain version on the view: it must equal
`topk_sparse_plain` on the transposed rows made contiguous, bit for bit,
and count no launch. `class_major` says which layouts the CUDA wrapper
hands to the kernel's class-tile launch.

On the card (tests marked `card`, skipped without a CUDA device; run them
with `python -m pytest tests/test_torch_topk_classes.py --noconftest -q`
from the root of a checkout, where no JAX is needed) the class-tile launch
must equal the plain version on every entry, padding included, at the
anchor counts of ssdlite320 (3,234), ssd300 (8,732) and ssd512 (24,732),
with 21 and 91 classes and k of 300 and 400, on rows of every branch
(`chip_smoke.long_topk_cases`: empty, compact, select, ties at the k-th
score, k - 1 / k / k + 1 live, one exponent bin, live scores in the tail)
laid into (B, A, C), the last class tile of each image partial where the
plan's tile does not divide C - 1; on rows whose live scores are all
equal; and on signed zeros below a negative threshold. Each call counts
one class-tile launch.

This file imports no JAX: the JAX reference of the reference core is held
to the port in tests/test_torch_topk.py.
"""

import pytest
import torch

import chip_smoke
from demonet_tpu_torch.ops import topk as port_topk

_THRESH, _SLOTS = 1e-3, 8


@pytest.fixture
def card():
    """Skip the test where no CUDA device is there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _laid(rows, c, seed, device):
    """(P, A) rows laid into (B, A, C) scores, row b * (C - 1) + j as
    class j + 1 of image b (B = ceil(P / (C - 1)); rows past P below every
    threshold), the background column random. Returns the scores and the
    rows as the (B, C - 1, A) contiguous tensor they are in the view."""
    p, a = rows.shape
    b = -(-p // (c - 1))
    fg = torch.full((b * (c - 1), a), -2.0, device=device)
    fg[:p] = rows
    fg = fg.reshape(b, c - 1, a)
    gen = torch.Generator(device).manual_seed(seed)
    scores = torch.empty((b, a, c), device=device)
    scores[..., 0] = torch.rand((b, a), generator=gen, device=device)
    scores[..., 1:] = fg.transpose(1, 2)
    return scores, fg


def _cases(a, k, device):
    cases = chip_smoke.long_topk_cases(6, a, _THRESH, k, _SLOTS, device)
    return torch.cat(list(cases.values()))


@pytest.mark.parametrize("a,c,k", [(1250, 6, 96), (1250, 21, 300),
                                   (3234, 21, 300)])
def test_cpu_op_on_the_view_equals_plain_on_contiguous_rows(a, c, k):
    scores, fg = _laid(_cases(a, k, "cpu"), c, seed=a, device="cpu")
    view = scores[..., 1:].transpose(1, 2)
    assert not view.is_contiguous() and torch.equal(view, fg)
    before = (port_topk.topk_sparse.launches,
              port_topk.topk_sparse.class_tile_launches)
    got = port_topk.topk_sparse(view, k, _THRESH, _SLOTS)
    want = port_topk.topk_sparse_plain(view.contiguous(), k, _THRESH)
    assert got[0].shape == got[1].shape == (*fg.shape[:2], k)
    assert got[0].is_contiguous() and got[1].is_contiguous()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    assert (got[0] > _THRESH).any() and (got[0] == float("-inf")).any()
    assert (port_topk.topk_sparse.launches,
            port_topk.topk_sparse.class_tile_launches) == before == (0, 0)


@pytest.mark.parametrize("make,want", [
    (lambda x: x[..., 1:].transpose(1, 2), (91, 50 * 91)),
    (lambda x: x[..., 1:].contiguous().transpose(1, 2), (90, 50 * 90)),
    (lambda x: x[:1, :, 1:2].transpose(1, 2), (91, 50 * 91)),
    (lambda x: x[..., 1:].transpose(1, 2).contiguous(), None),
    (lambda x: x[..., 1:], None),
    (lambda x: x[..., 1::2].transpose(1, 2), None),
    (lambda x: x[0, :, 1:].t(), None),
], ids=["view", "realized_slice", "one_row", "contiguous", "untransposed",
        "row_stride_2", "two_dims"])
def test_class_major_layouts(make, want):
    """The layouts the CUDA wrapper sends to the class-tile launch:
    (pitch, batch stride) where the rows lie side by side, None else
    (contiguous rows take the register or long-row launch; any other
    layout raises on CUDA)."""
    x = torch.rand(3, 50, 91)
    assert port_topk.class_major(make(x)) == want


@pytest.mark.card
@pytest.mark.parametrize("k", [300, 400])
@pytest.mark.parametrize("c", [21, 91])
@pytest.mark.parametrize("a", [3234, 8732, 24732])
def test_class_tile_launch_bit_equal_to_plain(card, a, c, k):
    scores, fg = _laid(_cases(a, k, "cuda"), c, seed=a + c + k,
                       device="cuda")
    view = scores[..., 1:].transpose(1, 2)
    tile, groups, smem = port_topk.class_tile_plan(a, k, _SLOTS, c - 1)
    assert 1 <= groups <= tile <= c - 1 and groups <= 4
    assert smem <= torch.cuda.get_device_properties(
        0).shared_memory_per_block_optin
    before = (port_topk.topk_sparse.launches,
              port_topk.topk_sparse.long_launches,
              port_topk.topk_sparse.class_tile_launches)
    got = port_topk.topk_sparse(view, k, _THRESH, _SLOTS)
    torch.cuda.synchronize()
    after = (port_topk.topk_sparse.launches,
             port_topk.topk_sparse.long_launches,
             port_topk.topk_sparse.class_tile_launches)
    assert after == (before[0] + 1, before[1], before[2] + 1)
    want = port_topk.topk_sparse_plain(fg, k, _THRESH)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    branches = chip_smoke.topk_branches(fg.reshape(-1, a), _THRESH, k,
                                        _SLOTS)
    assert min(branches["rows_empty"], branches["rows_compact"],
               branches["rows_select_radix"]) > 0, branches


@pytest.mark.card
@pytest.mark.parametrize("a", [3234, 8732])
def test_class_tile_launch_all_live_scores_equal(card, a):
    """Every live score of a row equal (the select needs no pass): the
    first k live anchors in index order."""
    rows = torch.full((90, a), 0.25, device="cuda")
    rows[:, ::3] = 1e-4
    rows[45:, a // 2:] = 1e-4
    scores, fg = _laid(rows, 91, seed=a, device="cuda")
    got = port_topk.topk_sparse(scores[..., 1:].transpose(1, 2), 400,
                                _THRESH, _SLOTS)
    want = port_topk.topk_sparse_plain(fg, 400, _THRESH)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


@pytest.mark.card
@pytest.mark.parametrize("a", [3234, 8732])
def test_class_tile_launch_signed_zeros(card, a):
    """-0.0 and +0.0 tie below a negative threshold, negatives live: the
    keys fold -0.0 onto +0.0 and the tie cut keeps index order."""
    gen = torch.Generator("cuda").manual_seed(a)
    values = torch.tensor([-0.0, 0.0, -0.5, 0.25, -1e-30, -2.0],
                          device="cuda")
    rows = values[torch.randint(0, 6, (2 * 90, a), generator=gen,
                                device="cuda")]
    scores, fg = _laid(rows, 91, seed=a, device="cuda")
    got = port_topk.topk_sparse(scores[..., 1:].transpose(1, 2), 400, -1.0,
                                _SLOTS)
    want = port_topk.topk_sparse_plain(fg, 400, -1.0)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])

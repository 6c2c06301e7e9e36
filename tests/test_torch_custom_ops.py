"""The kernels as `torch.library` custom ops
(demonet_tpu_torch/ops/library.py).

`torch.library.opcheck` holds each op's schema, fake (shape) function
and registrations against its CPU implementation, the kernel's plain
version, at small shapes. The public wrappers reach the plain versions
through the ops, and the ops keep a CUDA implementation (the kernel's
launch, which chip_smoke.py runs on the card and holds to the plain
version).
"""

import pytest
import torch

from demonet_tpu_torch.ops import gather as port_gather
from demonet_tpu_torch.ops import library
from demonet_tpu_torch.ops import nms as port_nms
from demonet_tpu_torch.ops import topk as port_topk

_OPS = ("nms_keep_batch", "gather_rows_batch", "topk_sparse")


def _nms_args(p=3, k=20, seed=0):
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand((p, k, 2), generator=g) * 50
    boxes = torch.cat([xy, xy + 10 + 5 * torch.rand((p, k, 2), generator=g)],
                      -1)
    scores = torch.sort(torch.rand((p, k), generator=g), dim=1,
                        descending=True).values
    scores[:, -3:] = -1e30                  # padding at the tail
    return boxes, scores.contiguous(), 0.5, -5e29


def _gather_args(coord_major, seed=1):
    g = torch.Generator().manual_seed(seed)
    table = torch.randn((2, 37, 4), generator=g)
    idx = torch.randint(0, 37, (2, 11), dtype=torch.int32, generator=g)
    return table, idx, coord_major


def _topk_args(lead, seed=2):
    g = torch.Generator().manual_seed(seed)
    scores = torch.rand((*lead, 300), generator=g)
    return scores, 10, 0.7, 8


@pytest.mark.parametrize("op,args", [
    ("nms_keep_batch", _nms_args()),
    ("nms_keep_batch", _nms_args(p=1, k=1)),
    ("gather_rows_batch", _gather_args(False)),
    ("gather_rows_batch", _gather_args(True)),
    ("topk_sparse", _topk_args((5,))),
    ("topk_sparse", _topk_args((2, 3))),
], ids=["nms", "nms_one", "gather_rows", "gather_coord_major", "topk_2d",
        "topk_3d"])
def test_opcheck(op, args):
    torch.library.opcheck(getattr(library, op), args)


@pytest.mark.parametrize("op", _OPS)
def test_ops_registered_for_cpu_and_cuda(op):
    name = f"{library.NAMESPACE}::{op}"
    for key in ("CPU", "CUDA"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(name, key), key
    assert callable(getattr(torch.ops.demonet_tpu_torch, op))


def test_wrappers_take_the_ops(monkeypatch):
    """Each public wrapper reaches its plain version through its op (the
    op's CPU implementation looks the plain version up in its module),
    and on the CPU counts no launch."""
    called = []
    for mod, name in ((port_nms, "nms_keep_batch_plain"),
                      (port_gather, "gather_rows_batch_plain"),
                      (port_topk, "topk_sparse_plain")):
        plain = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _p=plain, _n=name: (
            called.append(_n), _p(*a))[1])
    keep = port_nms.nms_keep_batch(*_nms_args())
    rows = port_gather.gather_rows_batch(*_gather_args(True))
    top = port_topk.topk_sparse(*_topk_args((2, 3)))
    assert called == ["nms_keep_batch_plain", "gather_rows_batch_plain",
                      "topk_sparse_plain"]
    assert keep.dtype == torch.bool and keep.shape == (3, 20)
    assert rows.shape == (2, 4, 11)
    assert top[0].shape == top[1].shape == (2, 3, 10)
    assert top[1].dtype == torch.int32
    assert port_nms.nms_keep_batch.launches == 0
    assert port_gather.gather_rows_batch.launches == 0
    assert port_topk.topk_sparse.launches == 0


def test_wrappers_refuse_devices_without_a_kernel():
    boxes, scores, iou, thr = _nms_args()
    with pytest.raises(ValueError, match="no kernel for meta"):
        port_nms.nms_keep_batch(boxes.to("meta"), scores.to("meta"), iou, thr)
    table, idx, _ = _gather_args(False)
    with pytest.raises(ValueError, match="no kernel for meta"):
        port_gather.gather_rows_batch(table.to("meta"), idx.to("meta"))
    with pytest.raises(ValueError, match="no kernel for meta"):
        port_topk.topk_sparse(torch.rand(2, 300, device="meta"), 10, 0.5)


def test_fake_shapes_under_export():
    """The ops trace as single nodes with their fake shapes: a function of
    the three wrappers exports, and its graph holds each op once."""
    class Three(torch.nn.Module):
        def forward(self, boxes, scores, rows):
            keep = port_nms.nms_keep_batch(boxes, scores, 0.5, -5e29)
            idx = keep.sum(1, keepdim=True).int().expand(-1, 2) % 20
            g = port_gather.gather_rows_batch(boxes, idx.contiguous(),
                                              coord_major=True)
            return keep, g, port_topk.topk_sparse(rows, 10, 0.7)

    boxes, scores, _, _ = _nms_args()
    rows = _topk_args((3,))[0]
    exported = torch.export.export(Three(), (boxes, scores, rows))
    targets = [str(n.target) for n in exported.graph.nodes
               if n.op == "call_function"]
    for op in _OPS:
        assert targets.count(f"demonet_tpu_torch.{op}.default") == 1, targets
    keep, g, (sc, ix) = exported.module()(boxes, scores, rows)
    assert keep.shape == (3, 20) and g.shape == (3, 4, 2)
    assert sc.shape == ix.shape == (3, 10)

"""``testing.pinned_choices``, which makes a card run of a LiDAR detector
take the CPU run's discrete choices (``chip_smoke.py``'s
``[lidar_variants]``) and a float32 run take a float64 run's
(``tests/test_torch_lidar_variants_raw.py``): each kind of choice is
replayed from the record, and a differing choice of the replaying run
counts as a tie only within rounding. Plain PyTorch on the CPU."""
import torch

from isfusion_tpu_torch.core.bbox import coders
from isfusion_tpu_torch.models.dense_heads import (anchor3d_head,
                                                   centerpoint_head,
                                                   transfusion_head)
from isfusion_tpu_torch.testing import pinned_choices


def _replay(call, first, second):
    """(recorded choice, replayed result, report) of ``call`` (which looks
    the pinned function up when called) on the arguments ``first``, then
    on ``second`` replaying the first."""
    with pinned_choices() as rec:
        want = call(*first)
    with pinned_choices(rec) as rep:
        got = call(*second)
    return want, got, rep


def test_relu_takes_the_recorded_signs_and_its_gradient():
    x = torch.tensor([-1.0, -1e-7, 2e-7, 3.0])
    y = torch.tensor([-1.0, 1e-7, -2e-7, 3.0], requires_grad=True)
    want, got, rep = _replay(lambda v: torch.relu(v), (x,), (y,))
    got.sum().backward()
    assert torch.equal(got.detach(), torch.tensor([0.0, 0.0, -2e-7, 3.0]))
    assert torch.equal(y.grad, torch.tensor([0.0, 0.0, 1.0, 1.0]))
    assert rep["flips"] == {"relu": 2} and rep["unexplained"] == []
    _, _, far = _replay(lambda v: torch.nn.functional.relu(v), (x,),
                        (torch.tensor([-1.0, 0.5, -2e-7, 3.0]),))
    assert [u["kind"] for u in far["unexplained"]] == ["relu"]


def test_topk_takes_the_recorded_picks_at_every_site():
    x = torch.tensor([[0.9, 0.5, 0.5 + 1e-7, 0.1]])
    y = torch.tensor([[0.9, 0.5 + 1e-7, 0.5, 0.1]])
    for module in (anchor3d_head, centerpoint_head, transfusion_head,
                   coders):
        want, got, rep = _replay(lambda v: module.topk_stable(v, 2), (x,),
                                 (y,))
        assert torch.equal(got, want) and torch.equal(want,
                                                      torch.tensor([[0, 2]]))
        assert rep["flips"] == {"topk": 1} and rep["unexplained"] == []
    _, _, far = _replay(lambda v: coders.topk_stable(v, 2), (x,),
                        (torch.tensor([[0.9, 0.7, 0.5, 0.1]]),))
    assert [u["kind"] for u in far["unexplained"]] == ["topk"]


def test_assignment_takes_the_recorded_matches():
    cost = torch.tensor([[[1.0, 2.0], [2.0, 1.0 + 1e-7], [5.0, 5.0]]])
    tied = torch.tensor([[[1.0 + 1e-7, 2.0], [2.0, 1.0], [5.0, 5.0]]])
    swapped = torch.tensor([[[2.0, 1.0], [1.0, 2.0], [5.0, 5.0]]])
    def call(c):
        return transfusion_head.assign_batch(c)

    want, got, rep = _replay(call, (cost,), (tied,))
    assert torch.equal(got, want) and rep["flips"] == {} and \
        rep["unexplained"] == []
    _, got, far = _replay(call, (cost,), (swapped,))
    assert torch.equal(got, want)
    assert [u["kind"] for u in far["unexplained"]] == ["assign"]


def _bev_pair(gap):
    """Two unit boxes ``gap`` apart along x (IoU (1 - gap) / (1 + gap))
    and a third far away; (1, 3, 5) boxes, (1, 1, 3) scores."""
    boxes = torch.tensor([[[0.0, 0, 1, 1, 0], [gap, 0, 1, 1, 0],
                           [9.0, 9, 1, 1, 0]]])
    return boxes, torch.tensor([[[0.9, 0.8, 0.7]]])


def test_bev_nms_keeps_the_recorded_mask_and_explains_ties():
    thr = 0.5
    at = 1 / 3                          # IoU exactly 0.5
    def call(*args):
        return anchor3d_head.nms_bev_mask(*args)

    want, got, rep = _replay(call, _bev_pair(at - 1e-6) + (thr,),
                             _bev_pair(at + 1e-6) + (thr,))
    assert torch.equal(want, torch.tensor([[[True, False, True]]]))
    assert torch.equal(got, want)
    assert rep["flips"] == {"nms_bev": 1} and rep["unexplained"] == []
    _, _, far = _replay(call, _bev_pair(0.1) + (thr,),
                        _bev_pair(0.9) + (thr,))
    assert [u["kind"] for u in far["unexplained"]] == ["nms_bev"]
    # the same suppression bits, the scores of a pair swapped far apart
    boxes, scores = _bev_pair(0.1)
    _, _, order = _replay(lambda *a: centerpoint_head.nms_bev_mask(*a),
                          (boxes, scores, thr),
                          (boxes, scores[..., [1, 0, 2]], thr))
    assert [u["kind"] for u in order["unexplained"]] == ["nms_bev"]


def test_circle_nms_keeps_the_recorded_mask_and_explains_ties():
    def sets(d):
        centers = torch.tensor([[[0.0, 0.0], [d, 0.0], [5.0, 5.0]]])
        return centers, torch.tensor([[0.9, 0.8, 0.7]])

    thr = torch.tensor([1.0])
    def call(*args):
        return centerpoint_head.circle_nms_mask(*args)

    want, got, rep = _replay(call, sets(1.0 - 1e-6) + (thr,),
                             sets(1.0 + 1e-6) + (thr,))
    assert torch.equal(want, torch.tensor([[True, False, True]]))
    assert torch.equal(got, want)
    assert rep["flips"] == {"nms_circle": 1} and rep["unexplained"] == []
    _, _, far = _replay(call, sets(0.5) + (thr,), sets(2.0) + (thr,))
    assert [u["kind"] for u in far["unexplained"]] == ["nms_circle"]


def test_a_record_of_other_shapes_is_refused_and_the_sites_restored():
    sites = [(torch, "relu"), (transfusion_head, "assign_batch"),
             (anchor3d_head, "nms_bev_mask"),
             (centerpoint_head, "nms_bev_mask"),
             (centerpoint_head, "circle_nms_mask")] + \
        [(m, "topk_stable") for m in (anchor3d_head, centerpoint_head,
                                      transfusion_head, coders)]
    real = [getattr(m, n) for m, n in sites]
    with pinned_choices() as rec:
        torch.relu(torch.zeros(3))
    try:
        with pinned_choices(rec):
            torch.relu(torch.zeros(4))
    except RuntimeError as e:
        assert "shapes" in str(e)
    else:
        raise AssertionError("a record of other shapes was replayed")
    assert all(getattr(m, n) is f for (m, n), f in zip(sites, real))

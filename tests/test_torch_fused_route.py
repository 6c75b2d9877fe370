"""The rule between the two paths of ``csrc/fused_assignment.cu``
(``kernels.ops.fused_assignment_route``): a pure function of the bucket's
shape and the card's SM count, so it is held here on the CPU. The paths
themselves are held against the plain version on the card
(``tests/test_torch_cuda.py``)."""
import pytest

from repro_torch.kernels import ops

H100_SMS = 132


@pytest.mark.parametrize("b,m,n,path", [
    (16, 1024, 1024, "lane"),        # fig1_points.batch's bucket
    (1, 10_000, 10_000, "grid"),     # fig1_points.solo's bucket
    (1, 20_000, 20_000, "grid"),     # no cluster's block holds the lane
    (4, 30_000, 30_000, "grid"),     # nor at any width
    (64, 29_000, 29_000, "grid"),    # won and y_a alone outgrow a block
    (64, 70_000, 100, "grid"),       # more rows than 32-bit won holds
    (1, 1024, 1024, "lane"),         # small: C SMs scan a round quickly
    (256, 1024, 1024, "lane"),
    (1, 2048, 2048, "lane"),         # still small
    (2, 4096, 4096, "grid"),         # large: 2 clusters of 8 SMs are few
    (4, 4096, 4096, "lane"),         # large, and the lanes fill an eighth
    (16, 4096, 4096, "lane"),
    (0, 1024, 1024, "grid"),         # an empty bucket
])
def test_the_route_of_a_bucket(b, m, n, path):
    assert ops.fused_assignment_route(b, m, n, H100_SMS).path == path


@pytest.mark.parametrize("b,m,n,cluster", [
    (1, 1024, 1024, 8), (16, 1024, 1024, 8), (17, 1024, 1024, 4),
    (64, 1024, 1024, 2), (132, 1024, 1024, 1), (256, 1024, 1024, 1),
    (16, 4096, 4096, 8), (64, 4096, 4096, 8)])
def test_the_cluster_size_of_a_lane(b, m, n, cluster):
    """A small lane takes the largest C whose b clusters fit the card's
    SMs; a large lane the largest C that holds it."""
    assert ops.fused_assignment_route(b, m, n, H100_SMS).cluster == cluster


@pytest.mark.parametrize("b,m,n", [
    (1, 24, 24), (3, 1024, 1024), (16, 1024, 1024), (17, 1024, 1024),
    (64, 1024, 1024), (256, 1024, 1024), (8, 4096, 4096),
    (64, 4096, 4096), (5, 300, 7000), (2, 15_000, 100)])
def test_a_lane_route_fits_its_cluster(b, m, n):
    """C is a portable cluster size (the launcher refuses more than 8),
    keeps every lane's block within a block's shared memory, and a small
    lane's b clusters fit the card's SMs where any C lets them."""
    r = ops.fused_assignment_route(b, m, n, H100_SMS)
    assert r.path == "lane"
    assert r.cluster in ops.LANE_CLUSTERS and 1 <= r.cluster <= 8
    assert ops.lane_smem_bytes(m, n, r.cluster) <= ops.LANE_SMEM_BYTES
    if m * n <= ops.LANE_SMALL_CELLS:
        assert b * r.cluster <= H100_SMS or r.cluster == 1


@pytest.mark.parametrize("sms", [66, 114, 132])
def test_the_grid_route_has_no_cluster(sms):
    r = ops.fused_assignment_route(1, 10_000, 10_000, sms)
    assert r == ops.Route("grid", 0)


@pytest.mark.parametrize("m,n,c", [(1024, 1024, 8), (1024, 1024, 1),
                                   (10_000, 10_000, 8), (7, 5, 4)])
def test_lane_shared_memory_is_the_kernel_layout(m, n, c):
    """What the rule relies on: a block holds won and y_a of every column
    and five vectors of its rows, 16-byte aligned, so the bytes are a
    multiple of 16, at least 8 n + 20 ceil(m / C), and no more in a wider
    cluster. That they are the kernel's own (``lane_layout``) is held on
    the card, against its C entry (``tests/test_torch_cuda.py``)."""
    got = ops.lane_smem_bytes(m, n, c)
    assert got % 16 == 0
    assert 8 * n + 20 * -(-m // c) <= got <= 8 * n + 20 * -(-m // c) + 7 * 15
    assert all(ops.lane_smem_bytes(m, n, w) <= got
               for w in ops.LANE_CLUSTERS if w > c)


@pytest.mark.parametrize("b,m,n", [(16, 64, 64), (1, 2100, 2100)])
def test_the_wrapper_launches_on_the_routes_path(monkeypatch, b, m, n):
    """``fused_run_assignment_phases`` hands the C entry the route's
    cluster (0 on the grid path, which alone queries a workspace), counts
    one launch either way, and counts the per-lane launches on the root
    span as ``fused_assignment.lane_path``. The tensors lie on the CPU,
    ``_on_cuda`` is patched to say they do not, and a recorder stands in
    for the C entry and ``torch.cuda.device``."""
    import contextlib

    import torch

    from repro_torch.core.pushrelabel import init_assignment_state
    from repro_torch.obs import tracing

    seen = []
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(ops, "_stream", lambda dev: 0)
    monkeypatch.setattr(ops, "_sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(ops, "build_kernels", lambda: 0.0)
    monkeypatch.setattr(ops, "launches", dict.fromkeys(ops._ENTRY, 0))
    monkeypatch.setattr(ops, "_libs", {
        "fused_assignment_phases": lambda *a: seen.append(a[-2]) or 0})
    monkeypatch.setattr(ops, "_workspace_fns", {
        "fused_assignment_phases":
            lambda *a: seen.append("ws") or 16})
    c = torch.zeros((b, m, n), dtype=torch.int32)
    state = init_assignment_state(b, m, n, "cpu")
    lim = torch.ones(b, dtype=torch.int32)
    route = ops.fused_assignment_route(b, m, n, H100_SMS)
    tracing.clear()
    tracing.record(True)
    try:
        with tracing.root("solve"):
            ops.fused_run_assignment_phases(c, state, lim * 0, lim, 2,
                                            m_valid=lim * m)
        (root,) = [s for s in tracing.recorded() if s["name"] == "solve"]
    finally:
        tracing.record(None)
        tracing.clear()
    lane = route.path == "lane"
    assert seen == ([route.cluster] if lane else ["ws", 0])
    assert ops.launches["fused_assignment_phases"] == 1
    assert root["launches"]["fused_assignment_phases"] == 1
    assert root["fused_assignment"]["lane_path"] == int(lane)

"""The arithmetic of the traced window and of the roofline shares."""
import pytest

from harness import roofline, trace


def test_union_and_gaps():
    iv = [(0, 10), (5, 20), (30, 40), (35, 36)]
    assert trace.union_seconds(iv) == pytest.approx(30e-6)
    assert trace.merged(iv) == [[0, 20], [30, 40]]
    assert trace.union_seconds([]) == 0.0


class FakeSession(trace.Session):
    def __init__(self):
        self.window = (0.0, 100.0)
        self.device_ops = [('k_a', 10.0, 30.0), ('k_b', 30.0, 40.0),
                           ('k_a', 60.0, 70.0), ('k_a', 95.0, 120.0)]
        self.host_ops = [('entry.fetch', 40.0, 60.0),
                         ('aten::copy_', 42.0, 58.0)]
        self.requests = 2


def test_summary_and_breakdown():
    s = FakeSession()
    sm = s.summary()
    assert sm['window_s'] == pytest.approx(100e-6)
    assert sm['busy_s'] == pytest.approx(45e-6)
    assert sm['ops'][-1] == ('k_a', 95.0, 100.0)
    b = s.breakdown()
    assert b['device_ops'][0] == ['k_a', pytest.approx(35e-6)]
    gaps = dict(b['idle_gaps'])
    # each point of a gap goes to the innermost span over it
    assert gaps['aten::copy_'] == pytest.approx(16e-6, rel=1e-3)
    assert gaps['entry.fetch'] == pytest.approx(4e-6, rel=1e-3)
    assert gaps['host outside any span'] == pytest.approx(35e-6, rel=1e-3)


def test_innermost():
    spans = [('A', 0, 100), ('B', 10, 20), ('C', 12, 15), ('D', 30, 90),
             ('E', 40, 41)]
    pts = [11, 13, 16, 25, 40.5, 95, 150, -1]
    assert trace.innermost(spans, pts) == ['B', 'C', 'B', 'A', 'E', 'A',
                                           None, None]


@pytest.mark.parametrize('kernel', sorted(roofline.KERNELS))
def test_roofline_at_most_100_when_time_is_at_least_the_bound(kernel):
    n = 1024 * 96000
    least = roofline.least_seconds(kernel, n)
    assert roofline.share(kernel, n, least) == pytest.approx(100.0)
    assert roofline.share(kernel, n, 2 * least) == pytest.approx(50.0)
    assert roofline.share(kernel, n, 0.0) is None
    assert roofline.share(kernel, 0, 1.0) is None
    # bytes bound both kernels: 8 B a sample at 3.35 TB/s
    assert least == pytest.approx(n * 8 / 3.35e12)


def test_readers_without_a_trace_read_nothing():
    import os
    from conftest import BASE
    from harness import cells

    class C:
        trace = None
        spans = {}
        stats = []
        memory_reserved_peak = 0
        csrc_kernels = {'wosc_fill_k'}
        config = {'oscillators': {'plain': 2, 'selfpm': 0}}
        traffic = {'voices': 4}
        samples_per_voice = 96000
    for f in os.listdir(os.path.join(BASE, 'metrics')):
        if f.endswith('.py'):
            assert cells.reader(f[:-3])(C) is None, f


def test_port_kernel_names():
    from harness.main import csrc_kernels
    names = csrc_kernels()
    assert {'wosc_fill_k', 'wosc_selfmod_rows'} <= names

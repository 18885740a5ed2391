"""``topk_bwd_ms.train`` on a hand-built profile: device ms a step in the
TopK backward's three kernels (by their names on the trace), nothing of
ATen's or kernel #4's, and nothing against a program without the passes or
a run without a profile."""

import types

from helpers import PB

from portbench import core
from portbench.tracing import Interval, Profile, base_name

NAME = "topk_bwd_ms.train"
TRACED = (
    "void (anonymous namespace)::topk_bwd_pair_kernel<__nv_bfloat16, 8>(__nv_bfloat16 "
    "const*, float const*, float const*, float const*, int, int, int, __nv_bfloat16*)",
    "void (anonymous namespace)::topk_bwd_route_kernel<float, 4>(float const*, float "
    "const*, float const*, float const*, float const*, int, int, int, float*, float*)",
    "void (anonymous namespace)::topk_bwd_colsum_kernel(float const*, int, int, float*)",
)
OTHERS = (
    "void at::native::elementwise_kernel<128, 2, void at::native::gpu_kernel_impl<"
    "at::native::CompareFunctor<float> >(at::TensorIteratorBase&)>(int, ...)",
    "void (anonymous namespace)::decode_kernel(CUtensorMap, CUtensorMap, float const*)",
)


def _reading(kernels, units=4):
    ivs = [Interval(n, base_name(n), 0.0, dur) for n, dur in kernels]
    profile = Profile(ivs, [], 1.0, sum(d for _, d in kernels), [], units)
    run = types.SimpleNamespace(config={}, traffic={}, profiled=profile)
    return core.Reading(run, core.Window({}, 0, 0, {}))


def _read(r):
    return core.metric_reader(NAME, PB).read(r)


def test_topk_bwd_reader_sums_the_passes_a_step():
    r = _reading([(TRACED[0], 0.004), (TRACED[1], 0.006), (TRACED[2], 0.0002),
                  (TRACED[1], 0.006), (OTHERS[0], 0.5), (OTHERS[1], 0.25)], units=2)
    assert abs(_read(r) - 1e3 * 0.0162 / 2) < 1e-9


def test_topk_bwd_reader_reads_nothing_without_the_passes():
    assert _read(_reading([(OTHERS[0], 0.5), (OTHERS[1], 0.25)])) is None
    run = types.SimpleNamespace(config={}, traffic={}, profiled=None)
    assert _read(core.Reading(run, core.Window({}, 0, 0, {}))) is None

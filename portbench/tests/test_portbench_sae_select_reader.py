"""``sae_select_ms.collect`` on hand-built profiles: device ms a batch in
the SAE encode's selection, read from the indexed selection's kernels or,
in a program that sorts the latent, from the sort's; nothing of the
encoder's or the training select's kernels, and nothing without a profile."""

import types

from helpers import PB

from portbench import core
from portbench.tracing import Interval, Profile, base_name

NAME = "sae_select_ms.collect"
INDEXED = (
    "void topk::select_indexed<topk::F32Value, 512, 10>(topk::SelectParams)",
    "void indexed::topk_merge_kernel<topk::F32Value>(unsigned int const*, int const*, int, "
    "int, void*, long*)",
)
SORT = (
    "void at_cuda_detail::cub::DeviceSegmentedRadixSortKernel<at_cuda_detail::cub::"
    "DeviceRadixSortPolicy<float, long, int>::Policy900, false, true, float, long, "
    "at_cuda_detail::cub::detail::radix::identity_decomposer_t>(float const*, float*, "
    "long const*, long*, int, int, int, int, int)",
    "void at::native::(anonymous namespace)::fill_reverse_indices_kernel<long>(long*, int, "
    "at::cuda::detail::IntDivider<unsigned int>)",
)
OTHERS = (
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_warpsize2x2x1_ffma",
    "void topk::select_rows<topk::Bf16Bits, 1024, 6, false>(topk::SelectParams)",
    "Memcpy DtoD (Device -> Device)",
)


def _reading(kernels, units=4):
    ivs = [Interval(n, base_name(n), 0.0, dur) for n, dur in kernels]
    profile = Profile(ivs, [], 1.0, sum(d for _, d in kernels), [], units)
    run = types.SimpleNamespace(config={}, traffic={}, profiled=profile)
    return core.Reading(run, core.Window({}, 0, 0, {}))


def _read(r):
    return core.metric_reader(NAME, PB).read(r)


def test_sae_select_reader_sums_the_indexed_selection_a_batch():
    r = _reading([(INDEXED[0], 0.004), (INDEXED[1], 0.0001), (INDEXED[0], 0.004),
                  (OTHERS[0], 0.6), (OTHERS[1], 0.002), (OTHERS[2], 0.003)], units=2)
    assert abs(_read(r) - 1e3 * 0.0081 / 2) < 1e-9


def test_sae_select_reader_reads_the_sort_of_a_program_without_it():
    r = _reading([(SORT[0], 0.07), (SORT[0], 0.001), (SORT[1], 0.0035), (OTHERS[0], 0.6),
                  (OTHERS[2], 0.0026)], units=1)
    assert abs(_read(r) - 1e3 * 0.0745) < 1e-9


def test_sae_select_reader_reads_nothing_without_either():
    assert _read(_reading([(OTHERS[0], 0.5), (OTHERS[1], 0.25)])) is None
    run = types.SimpleNamespace(config={}, traffic={}, profiled=None)
    assert _read(core.Reading(run, core.Window({}, 0, 0, {}))) is None

"""``chip_smoke.counter_of``: the kernels of a device trace, by name, to their launch counters.

``chip_smoke.py`` counts the kernels a replayed CUDA graph runs from the
profiler's trace, where no wrapper sees them.  The names below are the
demangled names the profiler gives the kernels of ``csrc/`` on the card.
"""

import pytest

import chip_smoke

SEEN_ON_THE_CARD = {
    "void fused::fused_solve_kernel<racing::Model>(fused::Params<racing::Model>, int)":
        "racing_fused_solve",
    "void fused::costs_dump_lambda_kernel<classic::Pendulum, false>(fused::Params<classic::"
    "Pendulum>, lsearch::Search, int*, float*)": "pendulum_costs_dump_lambda",
    "void fused::costs_dump_kernel<racing::Model>(fused::Params<racing::Model>)":
        "racing_costs_dump",
    "void fused::tick_tail_kernel<classic::Pendulum>(fused::Tail, classic::Pendulum::Args)":
        "pendulum_tick_tail",
    "(anonymous namespace)::weighted_kernel(float const*, float const*, float const*, int, int, "
    "float*, float*)": "fused_weighted",
    "void (anonymous namespace)::search_kernel<false>(float const*, int, float, float, float, "
    "int, float*)": "essps_lambda_fused",
    "void (anonymous namespace)::search_kernel<true>(float const*, int, float, float, float, "
    "int, float*)": "lbps_lambda_fused",
    "void (anonymous namespace)::weighted_update_kernel<4>(float const*, float const*, float "
    "const*, int, int, float*, float*)": "weighted_update_partials",
    "void fused::regen_rollout_kernel<fused::ActionsOnly<2> >(fused::Sampling<2>, long const*, "
    "int, float const*, fused::ActionsOnly<2>::Args, float*, float*, unsigned int const*, "
    "unsigned int*)": "fused_regen_m2",
    "void fused::regen_rollout_kernel<unicycle::NavigationModel>(fused::Sampling<2>, long "
    "const*, int, float const*, unicycle::NavigationModel::Args, float*, float*, unsigned int "
    "const*, unsigned int*)": "navigation_top_rollouts",
    "(anonymous namespace)::reference_rows_kernel(float const*, float const*, long const*, "
    "long const*, float, int, int, float*, long*)": "reference_rows",
    "(anonymous namespace)::racing_plant_kernel(float const*, long, long, float const*, long, "
    "long, int, int, float, float, float, float, float*)": "racing_plant",
    "(anonymous namespace)::mpcc_cost_kernel(float const*, long, long, float const*, long, long, "
    "float const*, long, long, float const*, long, (anonymous namespace)::Map, (anonymous "
    "namespace)::Map, (anonymous namespace)::Weights, int, int, float*)": "mpcc_cost",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
    "std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)":
        None,
    "void at::cuda::(anonymous namespace)::spin_kernel(long)": None,
    "Memcpy DtoD (Device -> Device)": None,
}


@pytest.mark.parametrize("name", sorted(SEEN_ON_THE_CARD))
def test_counter_of_names_seen_on_the_card(name):
    assert chip_smoke.counter_of(name) == SEEN_ON_THE_CARD[name]


def test_every_counter_is_reached_by_one_kernel_name():
    """Each launch counter has a kernel name of its own; none maps to two counters."""
    names = {}
    for function, suffix in chip_smoke.KERNEL_FUNCTIONS:
        for prefix, model in chip_smoke.KERNEL_MODELS:
            names[f"void fused::{function}{prefix}Model>(...)"] = f"{model}_{suffix}"
    for m in (1, 2):
        names[f"void fused::regen_rollout_kernel<fused::ActionsOnly<{m}> >(...)"] = (
            f"fused_regen_m{m}")
    mapped = {chip_smoke.counter_of(n): want for n, want in names.items()}
    assert all(got == want for got, want in mapped.items())
    reached = set(mapped) | {"fused_weighted", "essps_lambda_fused", "lbps_lambda_fused",
                             "weighted_update_partials", "reference_rows", "racing_plant",
                             "mpcc_cost"}
    assert reached == set(chip_smoke.launch_counters())


def test_a_kernel_of_an_unknown_model_is_an_error():
    with pytest.raises(ValueError, match="no launch counter"):
        chip_smoke.counter_of("void fused::fused_solve_kernel<quadrotor::Model>(...)")

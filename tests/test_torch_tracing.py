"""The port's tracing spans and counters (``utils/tracing.py``) on the
CPU: the spans are one shared null context with no profiler running and
``tnt.*`` host events under ``torch.profiler``, nested as the sweep's
layers are; the solve-tier and block-sparse executor counters; the
snapshot of every counter of the port and its reset."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tensornetwork_tpu_torch.blocksparse import batched as TBt
from tensornetwork_tpu_torch.blocksparse import torch_engine as TE
from tensornetwork_tpu_torch.models import symmetric_dmrg as TS
from tensornetwork_tpu_torch.models import vumps
from tensornetwork_tpu_torch.models.mpo import FiniteTFI
from tensornetwork_tpu_torch.models.symmetric_dmrg_batched import (
    BatchedSymmetricDMRG)
from tensornetwork_tpu_torch.ops import kernels, krylov
from tensornetwork_tpu_torch.parallel import collectives
from tensornetwork_tpu_torch.parallel.batch import (batched_one_site_sweep,
                                                    batched_two_site_sweep)
from tensornetwork_tpu_torch.utils import tracing

N, CHI, B = 6, 8, 3


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many tiny torch ops (see test_torch_tdvp.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _dense():
    mpo = FiniteTFI(1.0, 1.0, N=N, dtype=torch.float64, device="cpu")
    g = torch.Generator().manual_seed(0)
    As = torch.randn((B, N, CHI, 2, CHI), generator=g, dtype=torch.float64)
    return As, mpo


def _blocksparse():
    skel = TBt.uniform_skeleton_mps(N, CHI, dtype=torch.float64,
                                    device="cpu")
    data = TBt.random_data_batch(skel, B, seed=0, device="cpu")
    mpo = TS.u1_xxz_mpo(1.0, 1.0, 0.0, N, dtype=torch.float64, device="cpu")
    d = BatchedSymmetricDMRG(skel, data, mpo)
    d.precompile()
    return d, d.right_canonicalize()


def _spans(run):
    """``tnt.*`` host events of ``run()`` under the profiler: a list of
    (name without the prefix, start, end), by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    out = [(e.name()[len(tracing.PREFIX):], e.start_ns(),
            e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(tracing.PREFIX)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _inside(inner, outers):
    return any(s <= inner[1] and inner[2] <= e for _, s, e in outers)


def _of(spans, name):
    return [s for s in spans if s[0] == name]


def _one_site(kind):
    if kind == "dense":
        As, mpo = _dense()
        res = batched_one_site_sweep(As, mpo.Ws, mpo.vL, mpo.vR,
                                     num_krylov_vecs=6)

        def run():
            batched_one_site_sweep(res.As, mpo.Ws, mpo.vL, mpo.vR,
                                   num_krylov_vecs=6, renvs=res.renvs)
        return run, 2 * N
    d, R = _blocksparse()
    return (lambda: d.sweep_one_site(R)), 2 * (N - 1)


def test_span_is_one_shared_null_context_without_a_profiler():
    assert not tracing.enabled()
    a, b = tracing.span("sweep"), tracing.span("ritz")
    assert a is b and a is tracing._NULL
    with a:
        pass


def test_span_is_a_profiler_event_while_one_collects():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.enabled()
        with tracing.span("sweep"):
            torch.ones(2).sum()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("tnt.sweep") == 1


@pytest.mark.parametrize("kind", ["dense", "blocksparse"])
def test_one_site_sweep_spans_nest_as_its_layers(kind):
    run, solves = _one_site(kind)
    spans = _spans(run)
    assert {s[0] for s in spans} <= set(tracing.SPANS)
    sweep = _of(spans, "sweep")
    local = _of(spans, "local_solve")
    assert len(sweep) == 1 and len(local) == solves
    assert all(_inside(s, sweep) for s in spans if s[0] != "sweep")
    for name in ("lanczos", "ritz"):
        assert len(_of(spans, name)) == solves
        assert all(_inside(s, local) for s in _of(spans, name))
    gauge = _of(spans, "gauge_env")
    assert len(gauge) == solves
    assert not any(_inside(s, local) for s in gauge)
    if kind == "blocksparse":
        assert len(_of(spans, "program_lookup")) == solves
        assert all(_inside(s, gauge) for s in _of(spans, "shift"))
        execs = _of(spans, "bs_exec")
        assert execs and all(_inside(s, local) or _inside(s, gauge)
                             for s in execs)


@pytest.mark.parametrize("kind", ["dense", "blocksparse"])
def test_two_site_sweep_spans(kind):
    if kind == "dense":
        As, mpo = _dense()
        res = batched_two_site_sweep(As, mpo.Ws, mpo.vL, mpo.vR,
                                     num_krylov_vecs=6)

        def run():
            batched_two_site_sweep(res.As, mpo.Ws, mpo.vL, mpo.vR,
                                   num_krylov_vecs=6, renvs=res.renvs)
    else:
        d, R = _blocksparse()

        def run():
            d.sweep_two_site(R)
    spans = _spans(run)
    local, gauge = _of(spans, "local_solve"), _of(spans, "gauge_env")
    assert len(_of(spans, "sweep")) == 1
    assert len(local) == len(gauge) == 2 * (N - 1)
    assert all(_inside(s, local) for s in _of(spans, "ritz"))


def test_the_prepass_is_a_canon_span():
    As, mpo = _dense()
    spans = _spans(lambda: batched_one_site_sweep(As, mpo.Ws, mpo.vL,
                                                  mpo.vR, num_krylov_vecs=6))
    canon = _of(spans, "canon")
    assert len(canon) == 1 and _inside(canon[0], _of(spans, "sweep"))
    assert len([s for s in _of(spans, "gauge_env")
                if _inside(s, canon)]) == N
    d, _ = _blocksparse()
    spans = _spans(d.right_canonicalize)
    assert len(_of(spans, "canon")) == 1
    assert len(_of(spans, "program_lookup")) == N - 1


@pytest.mark.parametrize("impl", ["fused", "plain"])
def test_solve_tiers_sum_to_the_local_solves(impl):
    As, mpo = _dense()
    tracing.reset()
    batched_one_site_sweep(As, mpo.Ws, mpo.vL, mpo.vR, num_krylov_vecs=6,
                           lanczos_impl=impl)
    tiers = {k: v for k, v in tracing.counts.items()
             if k.startswith("solve_tier.")}
    assert sum(tiers.values()) == 2 * N
    assert list(tiers) == ["solve_tier." + ("resident" if impl == "fused"
                                            else "plain")]


def test_executor_counts_b_times_the_plan_flops():
    d, _ = _blocksparse()
    _, plan = d._program(2, "right").plans[0]
    true, padded = TE.plan_flops(plan)
    x1 = torch.randn(B, plan["nnz1"], dtype=torch.float64)
    x2 = torch.randn(B, plan["nnz2"], dtype=torch.float64)
    tracing.reset()
    for _ in range(2):
        plan["run"](x1, x2)
    assert tracing.counts["bs_true_flops"] == 2 * B * true
    assert tracing.counts["bs_padded_flops"] == 2 * B * padded
    assert tracing.counts["bs_gemms"] == 2 * len(plan["buckets"])
    assert 0 < true <= padded


def test_a_sweep_counts_the_flops_of_the_programs_it_visits():
    """The matvec chain ``min(m, nnz)`` times a solve, the absorption and
    the environment growth once: each program's seven plans, in the order
    it made them."""
    d, R = _blocksparse()
    want_true = want_padded = 0
    visits = ([(s, "right") for s in range(N - 1)]
              + [(s, "left") for s in range(N - 1, 0, -1)])
    for site, direction in visits:
        plans = [p for _, p in d._program(site, direction).plans]
        assert len(plans) == 7
        m = min(d.m, d.skeleton[site].data.shape[0])
        for k, plan in enumerate(plans):
            t, p = TE.plan_flops(plan)
            want_true += (m if k < 3 else 1) * t
            want_padded += (m if k < 3 else 1) * p
    tracing.reset()
    d.sweep_one_site(R)
    assert tracing.counts["bs_true_flops"] == B * want_true
    assert tracing.counts["bs_padded_flops"] == B * want_padded
    assert want_true <= want_padded


def test_snapshot_holds_every_counter_and_reset_zeroes_them():
    sources = {"kernels.launch_counts": kernels.launch_counts,
               "kernels.route_counts": kernels.route_counts,
               "krylov.counts": krylov.counts,
               "collectives.counts": collectives.counts,
               "vumps.counts": vumps.counts,
               "torch_engine.build_counts": TE.build_counts}
    tracing.reset()
    for d in sources.values():
        d[next(iter(d))] += 3
    tracing.add("solve_tier.resident", 2)
    tracing.add("bs_gemms", 5)
    snap = tracing.snapshot()
    for prefix, d in sources.items():
        for k, v in d.items():
            assert snap[f"{prefix}.{k}"] == v
    assert snap["solve_tier.resident"] == 2 and snap["bs_gemms"] == 5
    assert "_build.build_log" in snap
    tracing.reset()
    snap = tracing.snapshot()
    assert all(v == 0 for k, v in snap.items() if k != "_build.build_log")
    assert "solve_tier.resident" not in snap
    for d in sources.values():
        assert not any(d.values())


def test_the_utils_names_load_on_first_use():
    import tensornetwork_tpu_torch.utils as utils
    from tensornetwork_tpu_torch.utils.serialization import save_nodes
    assert utils.save_nodes is save_nodes
    with pytest.raises(AttributeError):
        utils.no_such_name

"""The port's Flora core against the reference package.

The paper's universe regenerated by both packages (the 180-execution
trace of 18 Spark jobs x 10 GCP configurations), the automatic
classifier, Flora's rankings and picks, the baselines and the paper's
experiments (Tables IV-V, Figs. 2-3) must agree exactly: the port's core
is float64 numpy like the reference's, so nothing is held to a
tolerance here.  Results are compared as plain data (dataclasses and
enums flattened), since each package has its own classes.
"""
import dataclasses
import enum

import pytest

from repro.core import baselines as ref_baselines
from repro.core import classification as ref_classification
from repro.core import costmodel as ref_costmodel
from repro.core import evaluate as ref_evaluate
from repro.core import spark_sim as ref_spark_sim
from repro.core.flora import Flora as RefFlora
from repro.core.flora import rank_generic as ref_rank_generic
from repro.core.trace import JobClass as RefJobClass
from repro_torch.core import (Flora, JobClass, JobSpec, PAPER_JOBS, Trace,
                              baselines, classification, costmodel,
                              evaluate, spark_sim)
from repro_torch.core.flora import rank_generic
from repro_torch.selector import (GcpVmCatalog, PriceTable, ProfilingStore,
                                  SelectionService)


def _plain(obj):
    """Dataclasses, enums and containers as plain comparable data."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {_plain(k): _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


@pytest.fixture(scope="module")
def traces():
    return spark_sim.generate_trace(seed=0), \
        ref_spark_sim.generate_trace(seed=0)


@pytest.fixture(scope="module")
def prices():
    return costmodel.LinearPriceModel(), ref_costmodel.LinearPriceModel()


# --- the trace ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_trace_equals_reference_record_for_record(seed):
    port = spark_sim.generate_trace(seed=seed)
    ref = ref_spark_sim.generate_trace(seed=seed)
    assert len(port.records) == len(ref.records) == 180
    for p, r in zip(port.records, ref.records):
        assert _plain(p) == _plain(r)
    assert port.to_json() == ref.to_json()


def test_trace_stats_equal_reference(traces, prices):
    (port, ref), (price, ref_price) = traces, prices
    assert port.stats(price) == ref.stats(ref_price)
    assert _plain(port.configs) == _plain(ref.configs)
    assert _plain(port.jobs) == _plain(ref.jobs)


def test_runtime_model_equals_reference_off_the_trace(traces):
    """The analytical model itself, at seeds and noise levels the trace
    does not use."""
    port, ref = traces
    for job, rjob in zip(port.jobs, ref.jobs):
        for cfg, rcfg in zip(port.configs, ref.configs):
            for seed, sigma in ((3, 0.0), (5, 0.2)):
                assert spark_sim.runtime_s(job, cfg, seed=seed,
                                           noise_sigma=sigma) == \
                    ref_spark_sim.runtime_s(rjob, rcfg, seed=seed,
                                            noise_sigma=sigma)
            assert spark_sim.usable_cache_gib(cfg) == \
                ref_spark_sim.usable_cache_gib(rcfg)


# --- classification -------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", sorted({j.algorithm
                                              for j in PAPER_JOBS}))
def test_classification_equals_reference(algorithm):
    expert = {j.algorithm: j.job_class for j in PAPER_JOBS}
    assert classification.auto_class(algorithm) is expert[algorithm]
    got = classification.classify(classification.profile_from_algo(
        algorithm))
    want = ref_classification.classify(
        ref_classification.profile_from_algo(algorithm))
    assert _plain(got) == _plain(want)


@pytest.mark.parametrize("stages", [
    (("select-where", 1.0, 0.0, False, 0.5),
     ("order-by", 2.5, 0.6, True, 0.5)),
    (("agg", 1.0, 0.9, False, 1.0),),
    (("iter", 10.0, 0.01, False, 1.0),),
    (("iter", 8.0, 0.7, False, 0.8), ("scan", 1.0, 0.1, False, 0.2)),
])
def test_stage_profiles_classify_as_reference(stages):
    def build(mod):
        return mod.JobProfile("p", stages=tuple(
            mod.StageProfile(n, passes, retained, random_access=ra,
                             weight=w)
            for n, passes, retained, ra, w in stages))
    assert _plain(classification.classify(build(classification))) == \
        _plain(ref_classification.classify(build(ref_classification)))


# --- Flora, the baselines, the paper's tables ---------------------------------------------

def test_flora_rankings_and_picks_equal_reference(traces, prices):
    (trace, ref_trace), (price, ref_price) = traces, prices
    flora, ref = Flora(trace, price), RefFlora(ref_trace, ref_price)
    fw1c = Flora(trace, price, one_class=True)
    ref_fw1c = RefFlora(ref_trace, ref_price, one_class=True)
    assert flora.service.backend == "numpy"
    for klass in JobClass:
        for excl in ((), ("Sort",), ("KMeans", "Grep")):
            rklass = RefJobClass(klass.value)
            assert _plain(flora.rank(klass, excl)) == \
                _plain(ref.rank(rklass, excl))
            assert _plain(fw1c.rank(klass, excl)) == \
                _plain(ref_fw1c.rank(rklass, excl))
    for job, rjob in zip(trace.jobs, ref_trace.jobs):
        assert flora.select_for_job(job).index == \
            ref.select_for_job(rjob).index


def test_rank_generic_equals_reference():
    rt = {("j1", "c1"): 1.0, ("j1", "c2"): 2.0, ("j2", "c1"): 3.0,
          ("j2", "c2"): 1.5}
    cost = {"ghost": 1.0, "c1": 2.0, "c2": 1.25}.get
    got = rank_generic(rt, ["j1", "j2"], ["ghost", "c1", "c2"], cost)
    want = ref_rank_generic(rt, ["j1", "j2"], ["ghost", "c1", "c2"], cost)
    assert _plain(got) == _plain(want)
    assert got[-1].config_id == "ghost" and got[-1].score == float("inf")


def test_baselines_select_as_reference(traces, prices):
    (trace, ref_trace), (price, ref_price) = traces, prices
    port = baselines.standard_approaches(trace, price)
    ref = ref_baselines.standard_approaches(ref_trace, ref_price)
    assert [a.name for a in port] == [a.name for a in ref]
    for a, r in zip(port, ref):
        for job, rjob in zip(trace.jobs, ref_trace.jobs):
            got, want = a.select(job), r.select(rjob)
            assert (got is None) == (want is None), (a.name, job.name)
            if got is not None:
                assert got.index == want.index, (a.name, job.name)
    jug = baselines.Juggler(trace.configs, price)
    assert jug.select(JobSpec("Grep", "Text", 3010, JobClass.B)) is None


@pytest.mark.parametrize("table", ["table4", "table5"])
def test_paper_tables_equal_reference(traces, prices, table):
    (trace, ref_trace), (price, ref_price) = traces, prices
    got = getattr(evaluate, table)(trace, price)
    want = getattr(ref_evaluate, table)(ref_trace, ref_price)
    assert _plain(got) == _plain(want)


def test_figures_and_crossover_equal_reference(traces, prices):
    (trace, ref_trace), (price, ref_price) = traces, prices
    ratios = [0.01, 0.1, 1.0, 10.0]
    assert evaluate.fig2_price_sweep(trace, price, ratios) == \
        ref_evaluate.fig2_price_sweep(ref_trace, ref_price, ratios)
    fractions = [0.0, 0.5, 1.0]
    assert evaluate.fig3_misclassification(trace, price, fractions) == \
        ref_evaluate.fig3_misclassification(ref_trace, ref_price,
                                            fractions)
    assert evaluate.crossover_fraction(trace, price) == \
        ref_evaluate.crossover_fraction(ref_trace, ref_price)


def test_table4_flora_row_is_near_optimal_and_best(traces, prices):
    """The paper's claim through the port: Flora's mean normalized cost
    is near 1 and beats every baseline of Table IV."""
    (trace, _), (price, _) = traces, prices
    rows = {r.name: r for r in evaluate.table4(trace, price)}
    flora = rows["Flora"]
    assert flora.mean_norm_cost < 1.15
    assert all(flora.mean_norm_cost < r.mean_norm_cost
               for name, r in rows.items() if name != "Flora")


def test_quickstart_picks_through_the_port(traces, prices):
    """The quickstart's outcome: class A -> #9, class B -> #1, through a
    numpy service over the port's catalog and store, and through Flora
    for every job of the paper."""
    (trace, _), (price, _) = traces, prices
    catalog = GcpVmCatalog(trace.configs, price)
    svc = SelectionService(catalog, ProfilingStore.from_trace(trace),
                           price, backend="numpy")
    a = svc.submit("PageRank", annotation=JobClass.A)
    b = svc.submit("Grep/new", annotation=JobClass.B)
    assert (a.entry.index, b.entry.index) == (9, 1)
    flora = Flora(trace, price)
    for job in trace.jobs:
        want = 9 if job.job_class is JobClass.A else 1
        assert flora.select_for_job(job).index == want, job.name


def test_leave_one_algorithm_out(traces, prices):
    (trace, _), (price, _) = traces, prices
    ranked = Flora(trace, price).rank(JobClass.A,
                                      exclude_algorithms=("Sort",))
    pruned = Trace(trace.configs,
                   [r for r in trace.records if r.job.algorithm != "Sort"])
    ranked2 = Flora(pruned, price).rank(JobClass.A)
    assert [r.config_id for r in ranked] == [r.config_id for r in ranked2]
    for a, b in zip(ranked, ranked2):
        assert a.score == pytest.approx(b.score)


def test_dynamic_evaluation_equals_reference_on_a_table_market(traces):
    """``dynamic_evaluation`` over the same decisions and price epochs:
    equal summaries in both packages."""
    from repro.market import SelectionDaemon as RefDaemon
    from repro.market import SimulatedSpotFeed as RefFeed
    from repro.market import synthetic_stream as ref_stream
    from repro.selector import GcpVmCatalog as RefCatalog
    from repro.selector import PriceTable as RefTable
    from repro.selector import ProfilingStore as RefStore
    from repro.selector import SelectionService as RefService
    from repro_torch.market import (JournalReplayer, SelectionDaemon,
                                    SimulatedSpotFeed, synthetic_stream)
    trace, ref_trace = traces
    price, ref_price = costmodel.LinearPriceModel(), \
        ref_costmodel.LinearPriceModel()
    cat = GcpVmCatalog(trace.configs, price)
    rcat = RefCatalog(ref_trace.configs, ref_price)
    svc = SelectionService(cat, ProfilingStore.from_trace(trace),
                           PriceTable.from_catalog(cat), backend="numpy")
    rsvc = RefService(rcat, RefStore.from_trace(ref_trace),
                      RefTable.from_catalog(rcat), backend="numpy")
    base = dict(PriceTable.from_catalog(cat).items())
    jobs = [j.name for j in trace.jobs]
    d = SelectionDaemon(svc, SimulatedSpotFeed(base, seed=5,
                                               change_fraction=0.4))
    d.run(synthetic_stream(jobs, 120, seed=2, tick_fraction=0.2))
    rd_ = RefDaemon(rsvc, RefFeed(base, seed=5, change_fraction=0.4))
    rd_.run(ref_stream(jobs, 120, seed=2, tick_fraction=0.2))
    assert d.journal_dump() == rd_.journal_dump()
    got = JournalReplayer(svc.store, d.journal_dump()).evaluate()
    from repro.market import JournalReplayer as RefReplayer
    want = RefReplayer(rsvc.store, rd_.journal_dump()).evaluate()
    assert got.summary() == want.summary()
    assert got.outcomes and got.mean_deviation >= 0.0

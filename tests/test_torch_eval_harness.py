"""The port's eval harness (mobius_rag_tpu_torch.eval_harness: bank, judge,
fact_checker, run, calibrate, matrix, derive_priors, lexical_oracle,
fixture_corpus) against the JAX package's, on the CPU with hash_embed.

Both packages run the same bank over the same corpus: the aggregates, the
per-query results (apart from latencies) and the doc ids each query
retrieved must be equal, and so must the calibration matrix, the derived
priors, the forced-strategy matrix, the BM25 oracle's rows and scores (the
scores within 1e-9: the same float64 sums) and the fixture stack's chunks.
The banks and the fixture corpus the port ships are copies of the JAX
package's (JSON for YAML): the copies must load to the same values, the
bank's sha included.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import yaml

from mobius_rag_tpu.eval_harness import (bank as jbank, calibrate as jcal,
                                         derive_priors as jdp, fact_checker as jfc,
                                         judge as jjudge, matrix as jmat, run as jrun)
from mobius_rag_tpu.eval_harness.db import EvalDB as JDB
from mobius_rag_tpu.eval_harness.fixture_corpus import (adversarial_corpus as jadv,
                                                        build_fixture_stack as jfix,
                                                        distractor_corpus as jdis)
from mobius_rag_tpu.eval_harness.lexical_oracle import BM25Oracle as JOracle
from mobius_rag_tpu.index.store import ChunkStore as JStore
from mobius_rag_tpu.query.agent import CorpusSearchAgent as JAgent
from mobius_rag_tpu.query.engine import SearchEngine as JEngine
from mobius_rag_tpu import testing as jtesting
from mobius_rag_tpu_torch.eval_harness import (bank, calibrate, derive_priors, fact_checker,
                                               judge, matrix, run)
from mobius_rag_tpu_torch.eval_harness.db import EvalDB
from mobius_rag_tpu_torch.eval_harness.fixture_corpus import (adversarial_corpus,
                                                              build_fixture_stack,
                                                              distractor_corpus)
from mobius_rag_tpu_torch.eval_harness.lexical_oracle import BM25Oracle
from mobius_rag_tpu_torch.index.store import ChunkStore
from mobius_rag_tpu_torch.query.agent import CorpusSearchAgent
from mobius_rag_tpu_torch.query.engine import SearchEngine
from mobius_rag_tpu_torch import testing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JDATA = os.path.join(REPO, "mobius_rag_tpu", "data")
TDATA = os.path.join(REPO, "mobius_rag_tpu_torch", "data")
TIMING = {"latency_ms", "latency_ms_median", "latency_ms_p95", "run_id", "calib_id",
          "prepare_ms", "device_ms", "wall_ms", "wall_ms_median", "wall_ms_p95",
          "device_ms_median"}


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in TIMING}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _recording(agent):
    """Wrap agent.run to record each answer's retrieved doc ids."""
    seen, run_fn = [], agent.run

    def recorded(req):
        res = run_fn(req)
        seen.append((req.query, [c.doc_id for c in res.chunks]))
        return res

    agent.run = recorded
    return seen


@pytest.fixture(scope="module")
def toy_agents():
    jlex, tlex = jtesting.sample_lexicon(), testing.sample_lexicon()
    js, ts = JStore(), ChunkStore(device="cpu")
    js.add_chunks(jtesting.toy_corpus(jlex, pad_docs=20))
    ts.add_chunks(testing.toy_corpus(tlex, pad_docs=20))
    return (JAgent(JEngine(js, jlex, embed_fn=jtesting.hash_embed)),
            CorpusSearchAgent(SearchEngine(ts, tlex, embed_fn=testing.hash_embed,
                                           device="cpu")))


@pytest.fixture(scope="module")
def fixture_stacks():
    return jfix(), build_fixture_stack(device="cpu")


# ---- banks and the corpus copy ---------------------------------------------

@pytest.mark.parametrize("name", ["toy", "cmhc_paraphrase"])
def test_bank_json_equals_jax_yaml(name):
    want, got = jbank.load_bank(name), bank.load_bank(name)
    assert (got.name, got.version, got.sha) == (want.name, want.version, want.sha)
    assert got.name == f"bank_{name}.yaml" and len(got.sha) == 16
    assert [dataclasses.asdict(q) for q in got.queries] == \
        [dataclasses.asdict(q) for q in want.queries]
    assert got.queries and got.queries[0].must_facts  # rubric folding


def test_bank_resolution_and_yaml_banks(tmp_path, monkeypatch):
    """A short name resolves against eval_bank_dir's YAML banks first (as
    `queries_<name>.yaml` too), then the port's JSON copies; a path to a
    YAML bank loads through PyYAML, with the sha of its bytes."""
    from mobius_rag_tpu_torch import config

    src = os.path.join(JDATA, "bank_toy.yaml")
    (tmp_path / "queries_mine.yaml").write_bytes(open(src, "rb").read())
    cfg = dataclasses.replace(config.get_config(), eval_bank_dir=str(tmp_path))
    monkeypatch.setattr(bank, "get_config", lambda: cfg)
    got = bank.load_bank("mine")
    assert got.name == "queries_mine.yaml" and got.sha == jbank.load_bank("toy").sha
    assert bank.load_bank("toy").name == "bank_toy.yaml"
    assert bank.load_bank(src).sha == got.sha
    with pytest.raises(FileNotFoundError, match="nope"):
        bank.load_bank("nope")


def test_fixture_corpus_copy_is_the_jax_corpus():
    jdir, tdir = os.path.join(JDATA, "corpus_cmhc"), os.path.join(TDATA, "corpus_cmhc")
    with open(os.path.join(jdir, "manifest.yaml")) as f:
        want = yaml.safe_load(f)
    with open(os.path.join(tdir, "manifest.json")) as f:
        assert json.load(f) == want
    docs = sorted(d["file"] for d in want["documents"])
    assert sorted(f for f in os.listdir(tdir) if f.endswith(".md")) == \
        sorted(f for f in os.listdir(jdir) if f.endswith(".md"))
    for name in docs:
        with open(os.path.join(jdir, name), "rb") as a, open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name


# ---- judge and fact checker -------------------------------------------------

CASES = [
    ("Participating providers must file within 180 days; non-participating providers "
     "have 365 days.", ["180 days for participating providers",
                        "365 days for non-participating providers"],
     ["disputes within 90 days"], ["no timely filing limit applies"]),
    ("The deadline is 190 days.", ["180 days for participating providers"], [], []),
    ("No timely filing limit applies; submit within 180 days.", ["180 days"], [],
     ["no timely filing limit applies"]),
    ("Unknown — cannot answer from the corpus.", ["180 days"], ["bonus"], []),
    ("", ["anything"], [], []),
    ("FL Medicaid: PA required for H0019.", ["Florida Medicaid requires PA for H0019",
                                            "no PA required"], [], []),
]


@pytest.mark.parametrize("answer,must,bonus,forbidden", CASES)
def test_judge_and_fact_checker_match_jax(answer, must, bonus, forbidden):
    want = jjudge.judge_answer(answer, must, bonus, forbidden)
    got = judge.judge_answer(answer, must, bonus, forbidden)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    chunks = ["Participating providers have 180 days; non-participating 365 days.",
              "Disputes within 90 days of the EOP."]
    for mode in ("recall", "grounding"):
        assert dataclasses.asdict(fact_checker.check_facts(must, chunks, answer, mode)) == \
            dataclasses.asdict(jfc.check_facts(must, chunks, answer, mode))


def test_judge_llm_path_via_the_ports_openai_adapter(monkeypatch):
    """The LLM rubric path through the port's concrete adapter against a
    local fake chat/completions server, and the env selection."""
    from test_judge_llm import _fake_chat_server, _semantic_stub

    from mobius_rag_tpu_torch.clients import HTTPLLMClient
    from mobius_rag_tpu_torch.providers_external import OpenAILLMClient

    srv, base, state = _fake_chat_server(_semantic_stub)
    try:
        llm = OpenAILLMClient(base_url=base, api_key="test-key")
        jr = judge.judge_answer(
            "For Florida Medicaid, the timely filing deadline is 180 days from the date of "
            "service; late claims are rejected.",
            must_facts=["timely filing deadline is 180 days",
                        "claims are denied after the deadline"],
            bonus_facts=["applies to Florida Medicaid"],
            forbidden_facts=["prior authorization is required first"], llm=llm)
        assert (jr.method, jr.verdict) == ("llm", "partial")
        assert jr.verdicts.must == [True, False] and jr.verdicts.forbidden == [False]
        assert state["requests"][0]["path"].endswith("/v1/chat/completions")
    finally:
        srv.shutdown()
    monkeypatch.delenv("MRAG_JUDGE_PROVIDER", raising=False)
    assert judge.get_judge_llm() is None
    monkeypatch.setenv("MRAG_JUDGE_PROVIDER", "openai")
    monkeypatch.setenv("MRAG_OPENAI_API_KEY", "k")
    assert isinstance(judge.get_judge_llm(), OpenAILLMClient)
    monkeypatch.setenv("MRAG_JUDGE_PROVIDER", "proxy")
    monkeypatch.setenv("MRAG_JUDGE_URL", "http://127.0.0.1:1/llm")
    assert isinstance(judge.get_judge_llm(), HTTPLLMClient)
    monkeypatch.setenv("MRAG_JUDGE_PROVIDER", "nope")
    with pytest.raises(ValueError):
        judge.get_judge_llm()


# ---- the runner, calibration, matrix, priors ----------------------------------

def _eval_both(jagent, tagent, name, tmp_path, **kw):
    jseen, tseen = _recording(jagent), _recording(tagent)
    try:
        want = jrun.run_eval(jagent, name, db=JDB(str(tmp_path / "j.sqlite")), **kw)
        got = run.run_eval(tagent, name, db=EvalDB(str(tmp_path / "t.sqlite")), **kw)
    finally:
        del jagent.run, tagent.run
    return want, got, jseen, tseen


@pytest.mark.parametrize("mode", [None, "b"])
def test_run_eval_toy_matches_jax(toy_agents, tmp_path, mode):
    want, got, jseen, tseen = _eval_both(*toy_agents, "toy", tmp_path, forced_mode=mode)
    assert _strip(got.aggregates) == _strip(want.aggregates)
    assert _strip(got.results) == _strip(want.results)
    assert tseen == jseen and any(ids for _, ids in tseen)
    agg = got.aggregates
    assert agg["n"] == 5 and agg["latency_ms_median"] > 0
    if mode is None:  # tests/test_eval_harness.py's floors
        assert agg["accuracy"] >= 0.6 and agg["citation_rate"] >= 0.75
        toy5 = [r for r in got.results if r["query_id"] == "toy005"][0]
        assert toy5["refused"] and toy5["checks"]["contour"]["ok"]
    db = EvalDB(str(tmp_path / "t.sqlite"))
    assert db.run(got.run_id)["aggregates"]["n"] == 5 and len(db.results(got.run_id)) == 5


def test_run_eval_fixture_paraphrase_bank_matches_jax(fixture_stacks, tmp_path):
    """The quality loop's eval: cmhc_paraphrase (51 queries) over the
    fixture stack, natural routing, in both packages."""
    (jagent, *_), (tagent, *_) = fixture_stacks
    want, got, jseen, tseen = _eval_both(jagent, tagent, "cmhc_paraphrase", tmp_path)
    assert got.aggregates["n"] == 51
    assert _strip(got.aggregates) == _strip(want.aggregates)
    assert _strip(got.results) == _strip(want.results)
    assert tseen == jseen


def test_calibrate_and_derive_priors_match_jax(toy_agents, tmp_path):
    jagent, tagent = toy_agents
    want = jcal.calibrate(jagent, "toy", db=JDB(str(tmp_path / "j.sqlite")))
    got = calibrate.calibrate(tagent, "toy", db=EvalDB(str(tmp_path / "t.sqlite")))
    assert set(got["per_run"]) == {"a", "b", "c", "d", "s", "natural"}
    assert _strip(got) == _strip(want)
    assert got["oracle_recall"] >= got["natural_recall"] - 1e-9
    out = {}
    for pkg, mod, res in (("jax", jdp, want), ("port", derive_priors, got)):
        path = str(tmp_path / f"{pkg}.json")
        info = mod.derive_priors(res["matrix"], "cafebabe", out_path=path, min_n=1)
        out[pkg] = (_strip({k: v for k, v in info.items() if k != "path"}),
                    json.load(open(path)))
    assert out["port"] == out["jax"] and out["port"][0]["updated_cells"] > 0
    from mobius_rag_tpu_torch.query.router import Router

    r = Router(priors_path=str(tmp_path / "port.json"))
    assert r.priors_version == "calib-cafebabe"
    assert r.decide({"query_class": "tight_pool", "canonicality": 0.0}).strategy


def test_derive_priors_skips_and_merge_match_jax(tmp_path):
    from mobius_rag_tpu_torch.query.router import _default_priors_path

    src = json.load(open(_default_priors_path()))
    sid = next(iter(src["priors"]))
    qc = next(iter(src["priors"][sid]))
    m = {sid: {qc: {"n": 5, "accuracy": 0.77, "accuracy_std": 0.1, "recall": 0.66},
               "zz_missing": {"n": 5, "accuracy": 0.5, "accuracy_std": 0.0, "recall": 0.5}},
         "natural": {qc: {"n": 5, "accuracy": 0.9, "accuracy_std": 0.0, "recall": 0.9}},
         "zz": {qc: {"n": 1, "accuracy": 0.1, "accuracy_std": 0.0, "recall": 0.1}}}
    outs = []
    for mod in (jdp, derive_priors):
        p = tmp_path / f"{mod.__name__}.json"
        p.write_text(json.dumps(src))
        info = mod.derive_priors(m, "cafebabe", priors_path=str(p), out_path=str(p), min_n=3)
        outs.append(({k: v for k, v in info.items() if k != "path"}, json.loads(p.read_text())))
    assert outs[0] == outs[1] and outs[1][0]["updated_cells"] == 1
    m1 = {"a": {"factual": {"n": 2, "accuracy": 1.0, "accuracy_std": 0.0, "recall": 0.8,
                            "recall_std": 0.0, "answer_rate": 1.0, "latency_ms_median": 10}}}
    m2 = {"a": {"factual": {"n": 2, "accuracy": 0.0, "accuracy_std": 0.0, "recall": 0.4,
                            "recall_std": 0.0, "answer_rate": 0.5, "latency_ms_median": 30}}}
    merged = derive_priors.merge_matrices([m1, m2])
    assert merged == jdp.merge_matrices([m1, m2])
    assert merged["a"]["factual"]["accuracy_std"] == 0.5


def test_run_matrix_and_timing_match_jax(toy_agents, tmp_path):
    jagent, tagent = toy_agents
    want = jmat.run_matrix(jagent, "toy", strategies=("a", "b"), repeats=2,
                           db=JDB(str(tmp_path / "j.sqlite")))
    got = matrix.run_matrix(tagent, "toy", strategies=("a", "b"), repeats=2,
                            db=EvalDB(str(tmp_path / "t.sqlite")))
    assert _strip(got) == _strip(want)
    nat = {"mean_chunk_recall": 0.5}
    assert _strip(matrix.analyze_matrix(got, natural_run=nat)) == \
        _strip(jmat.analyze_matrix(want, natural_run=nat))
    assert matrix.run_gate_on_bank(tagent, "toy") == jmat.run_gate_on_bank(jagent, "toy")
    t = matrix.time_queries(tagent, "toy")
    assert len(t["per_query"]) == 5 and t["wall_ms_median"] > 0


def test_bm25_oracle_matches_jax():
    jlex, tlex = jtesting.sample_lexicon(), testing.sample_lexicon()
    js, ts = JStore(), ChunkStore(device="cpu")
    js.add_chunks(jtesting.toy_corpus(jlex, pad_docs=40))
    ts.add_chunks(testing.toy_corpus(tlex, pad_docs=40))
    jo, to = JOracle(js), BM25Oracle(ts)
    assert (to.n, to.rows) == (jo.n, jo.rows) and to.avgdl == jo.avgdl
    for q in ("timely filing deadline for claims",
              "prior authorization for durable medical equipment",
              "payer id for electronic claims clearinghouse",
              "eligibility verification provider portal"):
        exp = tlex.expand(q).expansion_phrases
        got, want = to.search(q, exp, k=10), jo.search(q, jlex.expand(q).expansion_phrases, k=10)
        assert [r for r, _ in got] == [r for r, _ in want] and got
        assert all(abs(a - b) <= 1e-9 for (_, a), (_, b) in zip(got, want))


# ---- the fixture corpus --------------------------------------------------------

def test_fixture_stack_matches_jax(fixture_stacks):
    (_, jengine, jstore, _, jinfo), (_, engine, store, _, info) = fixture_stacks
    assert info == jinfo and store.size == jstore.size == info["chunks"] > 50
    fields = ("chunk_id", "doc_id", "text", "payer", "state", "filename", "section_path",
              "j_tags", "d_tags", "p_tags")
    rows = [tuple(getattr(r, f) for f in fields) for r in store.records if r is not None]
    want = [tuple(getattr(r, f) for f in fields) for r in jstore.records if r is not None]
    assert rows == want
    for mod_got, mod_want in ((distractor_corpus, jdis),):
        got = mod_got(40, engine.lexicon)
        exp = mod_want(40, jengine.lexicon)
        assert [(r.chunk_id, r.text, r.d_tags) for r in got] == \
            [(r.chunk_id, r.text, r.d_tags) for r in exp]
    got, exp = adversarial_corpus("toy", engine.lexicon), jadv("toy", jengine.lexicon)
    assert [(r.doc_id, r.text, r.extra["trap"]) for r in got] == \
        [(r.doc_id, r.text, r.extra["trap"]) for r in exp] and got


# ---- entry points and the nightly orchestrator ------------------------------

def test_eval_cli_on_the_toy_bank():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "mobius_rag_tpu_torch.eval_harness.run", "--bank", "toy",
         "--device", "cpu"], capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["n"] == 5 and out["run_id"]


def test_nightly_eval_steps_run(tmp_path):
    """The orchestrator's baseline and final evals run through run_eval and
    the lift is computed (they failed while the runner was unported)."""
    from test_torch_api import _context_under

    from mobius_rag_tpu_torch.nightly import NightlyOrchestrator

    ctx = _context_under(tmp_path)
    ctx.store.add_chunks(testing.toy_corpus(ctx.engine.lexicon))
    orch = NightlyOrchestrator(ctx, infra_up=lambda: {}, infra_down=lambda: {},
                               snapshot_path=str(tmp_path / "snap"))
    orch.start()
    orch.wait(240)
    steps = orch.status()["steps"]
    assert {s: steps[s]["status"] for s in ("baseline_eval", "final_eval", "lift")} == \
        dict.fromkeys(("baseline_eval", "final_eval", "lift"), "done"), steps
    assert steps["baseline_eval"]["detail"]["n"] == 5
    assert set(steps["lift"]["detail"]) == {"accuracy", "mean_chunk_recall", "answer_rate"}
    assert len(ctx.eval_db.list_runs(10)) == 2


def test_entry_points_default_to_cuda():
    import inspect

    assert inspect.signature(build_fixture_stack).parameters["device"].default == "cuda"
    src = open(os.path.join(REPO, "mobius_rag_tpu_torch", "eval_harness", "run.py")).read()
    assert 'ap.add_argument("--device", default="cuda"' in src

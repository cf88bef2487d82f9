"""PyTorch port vs the JAX package: offline analysis of episode records
(`eval/analyze.py`), the real-to-sim statistics (`eval/sim_metrics.py`)
and the language transforms (`eval/lang_transform.py`). The cases of
tests/test_cli_analysis.py, run through both packages; these are host
computations copied into the port, so every result must be equal."""

import io
import json
import os
import pickle

import numpy as np
import pytest

from cover_vla_tpu.eval import analyze as janalyze
from cover_vla_tpu.eval import lang_transform as jlang
from cover_vla_tpu.eval import sim_metrics as jsim

from cover_vla_tpu_torch.eval import analyze, lang_transform, sim_metrics
from cover_vla_tpu_torch.eval.evaluator import EpisodeResult, save_episode
from cover_vla_tpu_torch.eval.rephrase import load_rephrases


def _write_episode(out_dir, task, trial, seed, success, scores=(0.2, 0.3),
                   stats=None, instructions=None):
    os.makedirs(out_dir, exist_ok=True)
    stem = (f"episode_{task}_trial{trial}_seed{seed}_"
            f"{'success' if success else 'failure'}")
    with open(os.path.join(out_dir, stem + ".pkl"), "wb") as f:
        pickle.dump({"verifier_scores": list(scores),
                     "episode_stats": stats or {},
                     "selected_instructions": instructions or []}, f)


def _both(fn_name, *args, **kw):
    return (getattr(janalyze, fn_name)(*args, **kw),
            getattr(analyze, fn_name)(*args, **kw))


def test_analyze_aggregation(tmp_path):
    d = str(tmp_path)
    for i in range(4):
        _write_episode(d, "widowx_carrot_on_plate", i, 7, i % 2 == 0,
                       scores=(0.1 * i, None, 0.5))
    for i in range(2):
        _write_episode(d, "widowx_stack_cube", i, 7, True)
    (tmp_path / "episode_garbage.pkl").write_bytes(b"not a pickle")
    (tmp_path / "episode_widowx_x_trial0_seed1_success.pkl").write_bytes(b"")
    ref, got = _both("load_episodes", d)
    assert got == ref and len(got) == 7
    assert got[-1]["record"] is None           # unreadable record
    for period in (1, 2, 50):
        ref_agg, agg = _both("aggregate", got, seed_period=period)
        assert agg == ref_agg
    assert agg["per_task"]["widowx_carrot_on_plate"]["success_rate"] == 0.5
    assert analyze.render_table(agg) == janalyze.render_table(agg)
    ref_plot = janalyze.plot_success_rates(agg, str(tmp_path / "j.png"))
    plot = analyze.plot_success_rates(agg, str(tmp_path / "t.png"))
    assert (plot is None) == (ref_plot is None)
    assert plot is None or os.path.getsize(plot) > 0


def test_filename_parser():
    for name in ("notanepisode.pkl",
                 "episode_widowx_spoon_on_towel_trial3_seed9_failure.pkl",
                 "/a/b/episode_t_x_trial10_seed0_success.pkl",
                 "episode_t_trial1_seed2_success.pkl.bak"):
        assert analyze.extract_success_from_filename(name) == \
            janalyze.extract_success_from_filename(name)
    assert analyze.extract_success_from_filename(
        "episode_widowx_spoon_on_towel_trial3_seed9_failure.pkl") == {
        "task": "widowx_spoon_on_towel", "trial": 3, "seed": 9,
        "success": False}


def test_analyze_reads_the_ports_evaluator_records(tmp_path):
    """Records written by the port's `save_episode` aggregate as the JAX
    analyzer aggregates them."""
    d = str(tmp_path)
    for trial, (ok, instr) in enumerate([(True, ["a", "a"]),
                                         (False, ["a", "b"]),
                                         (True, ["a"])]):
        save_episode(EpisodeResult(
            "widowx_carrot_on_plate", trial, 7, ok, 8,
            {"moved_correct_obj": ok, "is_src_obj_grasped": True},
            [0.25, 0.5 * trial], instr, [np.zeros(7)], 1.0), d)
    ref, got = _both("load_episodes", d)
    assert [e["task"] for e in got] == [e["task"] for e in ref]
    for fn in ("aggregate", "partial_metric_breakdown",
               "instruction_switch_stats"):
        assert getattr(analyze, fn)(got) == getattr(janalyze, fn)(ref), fn
    assert analyze.instruction_switch_stats(got)["switch_rate"] == 1 / 3


def test_analyze_partial_breakdown_switches_and_compare(tmp_path, capsys):
    a, b = str(tmp_path / "runA"), str(tmp_path / "runB")
    _write_episode(a, "widowx_carrot_on_plate", 0, 7, True,
                   stats={"moved_correct_obj": True,
                          "is_src_obj_grasped": True,
                          "consecutive_grasp": True},
                   instructions=["stack blocks", "stack blocks"])
    _write_episode(a, "widowx_carrot_on_plate", 1, 7, False,
                   stats={"moved_correct_obj": False,
                          "moved_wrong_obj": True,
                          "is_src_obj_grasped": False,
                          "consecutive_grasp": False},
                   instructions=["stack blocks", "pile the cubes"])
    for i in range(4):
        _write_episode(a, "widowx_stack_cube", i + 2, 7, i % 2 == 0)
        _write_episode(b, "widowx_stack_cube", i, 7, True)
    eps = analyze.load_episodes(a)
    bd = analyze.partial_metric_breakdown(eps)
    assert bd == janalyze.partial_metric_breakdown(eps)
    assert bd["widowx_carrot_on_plate"]["moved_wrong_obj"] == 1.0
    assert analyze.render_partial_table(bd) == \
        janalyze.render_partial_table(bd)
    sw = analyze.instruction_switch_stats(eps)
    assert sw == janalyze.instruction_switch_stats(eps)
    assert (sw["episodes"], sw["episodes_with_switch"]) == (2, 1)
    cmp = analyze.compare_runs({"A": a, "B": b}, seed_period=2)
    assert cmp == janalyze.compare_runs({"A": a, "B": b}, seed_period=2)
    assert cmp["table"]["widowx_carrot_on_plate"]["B"] is None
    assert analyze.render_comparison(cmp) == janalyze.render_comparison(cmp)
    plot = analyze.plot_comparison(cmp, str(tmp_path / "cmp.png"))
    assert plot is None or os.path.exists(plot)
    # the CLI prints the same text in both packages
    argv = [a, "--partial", "--switches", "--compare", f"B={b}",
            "--seed-period", "2"]
    capsys.readouterr()
    janalyze.main(argv)
    ref = capsys.readouterr().out
    analyze.main(argv)
    assert capsys.readouterr().out == ref and "OVERALL" in ref


@pytest.mark.parametrize("seed", [0, 1])
def test_sim_metrics_equal(seed):
    rng = np.random.default_rng(seed)
    real, sim = rng.uniform(0, 1, 6), rng.uniform(0, 1, 6)
    cases = [(real, sim), ([0.2, 0.5, 0.8], [0.25, 0.55, 0.75]),
             ([0.2, 0.5, 0.8], [0.8, 0.5, 0.2]), ([0.5] * 3, [0.1, 0.2, 0.3])]
    for r, s in cases:
        assert sim_metrics.pearson_correlation(r, s) == \
            jsim.pearson_correlation(r, s)
        assert sim_metrics.mean_maximum_rank_violation(r, s) == \
            jsim.mean_maximum_rank_violation(r, s)
    real_eps = [rng.integers(0, 2, 8).tolist() for _ in range(3)] + [[1, 1]]
    sim_eps = [rng.integers(0, 2, 8).tolist() for _ in range(3)] + [[1, 1]]
    got = sim_metrics.kruskal_wallis(real_eps, sim_eps)
    assert got == jsim.kruskal_wallis(real_eps, sim_eps)
    assert got["per_policy"][-1] == {"statistic": 0.0, "pvalue": 1.0}
    assert sim_metrics.mean_maximum_rank_violation(
        [0.2, 0.5, 0.8], [0.8, 0.5, 0.2]) > 0.3


@pytest.mark.parametrize("seed", [0, 3])
def test_lang_transforms_equal(seed):
    got_lt = lang_transform.LangTransform(seed=seed)
    ref_lt = jlang.LangTransform(seed=seed)
    assert lang_transform.TRANSFORM_TYPES == jlang.TRANSFORM_TYPES
    for instr in ("put the carrot on the plate", "open top drawer"):
        for tt in lang_transform.TRANSFORM_TYPES:
            for n in (1, 5):
                assert got_lt.transform(instr, tt, n=n) == \
                    ref_lt.transform(instr, tt, n=n), (instr, tt, n)
    with pytest.raises(ValueError):
        got_lt.transform("x", "bogus")


def test_generate_rephrase_store_equal(tmp_path):
    from cover_vla_tpu_torch.eval.benchmark import TASK_INSTRUCTIONS
    instructions = sorted(set(TASK_INSTRUCTIONS.values()))[:6]
    store = lang_transform.generate_rephrase_store(
        instructions, n_per_task=8, backend=lang_transform.TemplateBackend(0))
    assert store == jlang.generate_rephrase_store(
        instructions, n_per_task=8, backend=jlang.TemplateBackend(0))
    entry = store["instructions"][instructions[0]]
    assert 4 <= entry["count"] == len(entry["ert_rephrases"]) <= 8
    path = tmp_path / "reph.json"
    path.write_text(json.dumps(store))
    assert load_rephrases(str(path))[instructions[0]] == entry["ert_rephrases"]
    # the CLI writes the same store from the benchmark's tasks
    lang_transform.main([str(tmp_path / "t.json"), "--n-per-task", "3"])
    jlang.main([str(tmp_path / "j.json"), "--n-per-task", "3"])
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()


def test_openai_backend_request_and_fallback(monkeypatch):
    """The OpenAI-compatible backend against a stubbed endpoint (no
    network): the same request body, headers and parsed rephrases in both
    packages; `auto` falls back to the template backend without a key,
    and a failing endpoint raises after the retries."""
    import urllib.request

    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    assert isinstance(lang_transform.make_backend("auto"),
                      lang_transform.TemplateBackend)
    with pytest.raises(ValueError):
        lang_transform.OpenAICompatibleBackend()
    with pytest.raises(ValueError):
        lang_transform.make_backend("bogus")

    class _Resp(io.BytesIO):
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    captured = []

    def fake_urlopen(req, timeout=None):
        captured.append((req.full_url, json.loads(req.data.decode()),
                         req.headers.get("Authorization"), timeout))
        return _Resp(json.dumps({"choices": [{"message": {"content":
            "1. place the carrot on the dish\n"
            "2) set the carrot onto the plate\n"
            "- move the carrot to the plate\n"
            "- move the carrot to the plate\n"}}]}).encode())

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    outs = []
    for mod in (jlang, lang_transform):
        be = mod.make_backend("openai", api_key="k",
                              base_url="http://fake/v1/", model="m")
        outs.append(be.rephrase("put carrot on plate", 3, image=b"\x89PNG"))
    assert outs[0] == outs[1] == ["place the carrot on the dish",
                                  "set the carrot onto the plate",
                                  "move the carrot to the plate"]
    assert captured[0] == captured[1]
    url, body, auth, _ = captured[1]
    assert url == "http://fake/v1/chat/completions" and auth == "Bearer k"
    assert body["messages"][0]["content"][1]["type"] == "image_url"

    def failing(req, timeout=None):
        raise OSError("endpoint down")
    monkeypatch.setattr(urllib.request, "urlopen", failing)
    be = lang_transform.OpenAICompatibleBackend(api_key="k", max_retries=1)
    with pytest.raises(RuntimeError, match="2 attempts"):
        be.rephrase("x", 2)

"""The RAFT retraining tools of the port (``mav_detection_tpu_torch/tools``:
``finetune_raft``, ``soup_raft``, ``pan_curriculum``) on the CPU.

Training and the evals run on the card in ``chip_smoke.py``; here the
tools' own logic is held to the reference's on fixed inputs:

* the gates dicts equal the reference tools' (their ``main`` run with the
  evals and training replaced by fixed numbers, the dict read from their
  log);
* a candidate the port trains and writes loads in the JAX package's
  ``checkpoint.load_msgpack`` with the port model's weights, exactly;
* soups at alpha 0 and 1 equal their endpoints exactly, at 0.5 the
  reference's ``jax.tree_util.tree_map`` soup of the same two files
  exactly, and bfloat16 leaves round as numpy's bfloat16 (ml_dtypes)
  rounds them;
* ``--ship`` without ``MAV_CHECKPOINT_PATH`` raises before any training,
  and with it copies a passing candidate there only;
* the curriculum skips exactly the phases with a sentinel and runs again a
  phase killed mid-run (its candidate present, no sentinel);
* every tool raises without a card.
"""
import hashlib
import json
import logging
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from mav_detection_tpu_torch.convert import flax_from_raft_state_dict
from mav_detection_tpu_torch.models import checkpoint, pretrained
from mav_detection_tpu_torch.tools import finetune_raft, pan_curriculum, soup_raft

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SHIPPED = REPO / "checkpoints" / "raft.msgpack"
BASE = {"eval_epe": 0.4964, "drone_epe": 0.3571, "bench_epe": 0.2219,
        "bench_drone_epe": 0.4173, "sim_epe": 0.3819, "sim_drone_epe": 0.5775,
        "shift_ladder": 13.57}
CANDS = {
    "passing": {"eval_epe": 0.41, "drone_epe": 0.3, "det_tpr": 0.98, "det_tpr_gt": 1.0,
                "bench_epe": 0.2, "bench_drone_epe": 0.4, "sim_epe": 0.35,
                "sim_drone_epe": 0.5, "shift_ladder": 0.45},
    "failing": {"eval_epe": 0.52, "drone_epe": 0.31, "det_tpr": 0.9, "det_tpr_gt": 1.0,
                "bench_epe": 0.41, "bench_drone_epe": 0.5, "sim_epe": 0.71,
                "sim_drone_epe": 0.6, "shift_ladder": 0.7},
}


@pytest.fixture
def rng():
    return np.random.default_rng(21)


@pytest.fixture(autouse=True)
def fresh_cache():
    pretrained.clear_cache()
    yield
    pretrained.clear_cache()


def _sha(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def _log_json(caplog, prefix: str) -> list:
    """The JSON objects logged after ``prefix`` (the reference's lines)."""
    out = []
    for r in caplog.records:
        msg = r.getMessage()
        if prefix in msg:
            out.append(json.loads(msg.split(prefix, 1)[1].split(" | ")[0]))
    return out


def _reference_stubs(monkeypatch, base, cand):
    """The reference's evals and training replaced by fixed numbers: the
    first call of each eval gives the shipped weights', later ones the
    candidate's."""
    from mav_detection_tpu.cli import train as jtrain
    from mav_detection_tpu.models import checkpoint as jck
    from mav_detection_tpu.models import pretrained as jpre

    import tools.finetune_raft as jft

    def seq(*values):
        it = iter(values)
        return lambda *a, **k: next(it)

    cd = {k: base[k] for k in ("bench_epe", "bench_drone_epe", "sim_epe", "sim_drone_epe")}
    cd1 = {k: cand[k] for k in cd}
    monkeypatch.setattr(jtrain, "eval_raft", seq((base["eval_epe"], base["drone_epe"]),
                                                 *[(cand["eval_epe"], cand["drone_epe"])] * 4))
    monkeypatch.setattr(jtrain, "eval_raft_detection",
                        lambda *a, **k: (cand["det_tpr"], cand["det_tpr_gt"]))
    monkeypatch.setattr(jtrain, "shift_ladder_epe",
                        seq(base["shift_ladder"], *[cand["shift_ladder"]] * 4))
    monkeypatch.setattr(jtrain, "train_raft", lambda **k: ({"w": np.zeros(2)}, None))
    monkeypatch.setattr(jft, "cross_domain", seq(cd, *[cd1] * 4))
    monkeypatch.setattr(jpre, "load_raft_params", lambda *a, **k: {"w": np.zeros(2)})
    monkeypatch.setattr(jck, "save_msgpack", lambda *a, **k: None)
    monkeypatch.setattr(jck, "load_msgpack", lambda *a, **k: {"w": np.ones(2)})


@pytest.mark.parametrize("pan_max", [0.0, 12.0])
@pytest.mark.parametrize("which", sorted(CANDS))
def test_finetune_gates_equal_the_reference(monkeypatch, caplog, tmp_path, which, pan_max):
    import tools.finetune_raft as jft

    cand = CANDS[which]
    _reference_stubs(monkeypatch, BASE, cand)
    monkeypatch.setattr("sys.argv", ["finetune_raft.py", "--pan-max", str(pan_max),
                                     "--candidate", str(tmp_path / "c.msgpack")])
    caplog.set_level(logging.INFO)
    jft.main()
    (want,) = _log_json(caplog, "gates: ")
    got = finetune_raft.gates(BASE, cand, pan_max)
    assert list(got.items()) == list(want.items())
    assert all(got.values()) == (which == "passing")


@pytest.mark.parametrize("ladder_gate", [0.5, 0.3])
def test_soup_gates_equal_the_reference(monkeypatch, caplog, ladder_gate):
    import tools.soup_raft as jsoup

    _reference_stubs(monkeypatch, BASE, CANDS["passing"])
    monkeypatch.setattr("sys.argv", ["soup_raft.py", "--candidate", "c.msgpack",
                                     "--alphas", "0.5", "--ladder-gate", str(ladder_gate)])
    caplog.set_level(logging.INFO)
    jsoup.main()
    (want,) = _log_json(caplog, "| gates ")
    got = soup_raft.soup_gates(BASE, CANDS["passing"], ladder_gate)
    assert list(got.items()) == list(want.items())
    assert got["shift_ladder<=0.5"] == (ladder_gate == 0.5)


# ----------------------------------------------------------------- finetune
def _tiny_training(monkeypatch, seen=None):
    """finetune_raft's training at 64x64, batch 2, without the selector, and
    its evals replaced by fixed numbers (the chip smoke run trains and
    evaluates at the tool's sizes)."""
    real = finetune_raft.train_raft

    def train(**kw):
        if seen is not None:
            seen.append(kw)
        return real(**dict(kw, steps=2, chunk=1, hw=(64, 64), batch=2, iters=2,
                           use_selector=False))

    evals = iter([BASE] + [CANDS["passing"]] * 4)
    monkeypatch.setattr(finetune_raft, "train_raft", train)
    monkeypatch.setattr(finetune_raft, "evaluate", lambda *a, **k: dict(next(evals)))


def test_candidate_loads_in_the_jax_package(monkeypatch, tmp_path, capsys):
    """A candidate the port trains and writes is read by the JAX package's
    load_msgpack (the reference's restore into the shipped template) with
    the port model's weights; --init resumes from it."""
    from flax import traverse_util

    from mav_detection_tpu.models import checkpoint as jck
    from mav_detection_tpu.models import pretrained as jpre

    seen = []
    _tiny_training(monkeypatch, seen)
    path = tmp_path / "cand.msgpack"
    res = finetune_raft.main(["--steps", "2", "--candidate", str(path), "--pan-max", "6"],
                             device="cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["all_pass"]
    assert res["gates"]["shift_ladder<=0.5"] and res["shipped_to"] is None
    assert seen[0]["pan_max"] == 6.0 and seen[0]["save_best_to"] == str(path)
    tree = jck.load_msgpack(str(path), _jax_template(), migrate=jpre._migrate_raft_state)
    ours = traverse_util.flatten_dict(checkpoint.load_msgpack(str(path)))
    theirs = traverse_util.flatten_dict(tree)
    assert sorted(ours) == sorted(theirs) and len(ours) == 92
    for k in ours:
        np.testing.assert_array_equal(np.asarray(theirs[k]), ours[k])
    moved = [k for k in ours if not np.array_equal(
        ours[k], traverse_util.flatten_dict(checkpoint.load_msgpack(
            str(SHIPPED), migrate=pretrained._migrate_raft_state))[k])]
    assert moved, "two steps of training changed no weight"
    # --init reads it back through the port's reader
    seen.clear()
    _tiny_training(monkeypatch, seen)
    finetune_raft.main(["--steps", "2", "--candidate", str(tmp_path / "c2.msgpack"),
                        "--init", str(path)], device="cpu")
    init = seen[0]["init_params"]
    model = finetune_raft.model_from_tree(checkpoint.load_msgpack(str(path)), "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(init[k], v), k


@pytest.mark.parametrize("tool", ["finetune_raft", "soup_raft", "pan_curriculum"])
def test_ship_without_the_variable_raises_before_training(monkeypatch, tool):
    monkeypatch.delenv("MAV_CHECKPOINT_PATH", raising=False)

    def never(*a, **k):
        raise AssertionError("trained or evaluated before refusing --ship")

    monkeypatch.setattr(finetune_raft, "train_raft", never)
    monkeypatch.setattr(finetune_raft, "evaluate", never)
    argv = {"finetune_raft": ["--ship"], "soup_raft": ["--candidate", "x", "--ship"],
            "pan_curriculum": []}[tool]
    mod = {"finetune_raft": finetune_raft, "soup_raft": soup_raft,
           "pan_curriculum": pan_curriculum}[tool]
    with pytest.raises(RuntimeError, match="MAV_CHECKPOINT_PATH"):
        mod.main(argv, device="cpu")


def test_ship_copies_a_passing_candidate_under_the_variable(monkeypatch, tmp_path):
    before = _sha(SHIPPED)
    ck = tmp_path / "ck"
    ck.mkdir()
    shutil.copy(SHIPPED, ck / "raft.msgpack")
    monkeypatch.setenv("MAV_CHECKPOINT_PATH", str(ck))
    _tiny_training(monkeypatch)
    res = finetune_raft.main(["--steps", "2", "--candidate", str(tmp_path / "c.msgpack"),
                              "--ship"], device="cpu")
    assert res["shipped_to"] == str(ck / "raft.msgpack")
    assert _sha(ck / "raft.msgpack") == _sha(tmp_path / "c.msgpack") != before
    assert _sha(SHIPPED) == before


@pytest.mark.parametrize("tool", ["finetune_raft", "soup_raft", "pan_curriculum"])
def test_tool_raises_without_a_card(monkeypatch, tmp_path, tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path cannot be shown")
    monkeypatch.setenv("MAV_CHECKPOINT_PATH", str(tmp_path))
    mod = {"finetune_raft": finetune_raft, "soup_raft": soup_raft,
           "pan_curriculum": pan_curriculum}[tool]
    argv = ["--candidate", "x"] if tool == "soup_raft" else []
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main(argv)


# --------------------------------------------------------------------- soup
@pytest.fixture(scope="module")
def candidate_file(tmp_path_factory):
    """The shipped weights moved by seeded noise, written by the port."""
    rng = np.random.default_rng(3)
    sd = {k: v + torch.from_numpy(rng.normal(scale=1e-2, size=v.shape).astype(np.float32))
          for k, v in pretrained.load_raft_params().items()}
    path = tmp_path_factory.mktemp("soup") / "cand.msgpack"
    checkpoint.save_msgpack(str(path), flax_from_raft_state_dict(sd))
    return path


def _jax_template():
    """The shipped RAFT tree as Flax restores it (the template the JAX
    package's ``load_msgpack`` restores into; ``load_raft_params`` would
    build it by initialising the net, a long compile)."""
    from flax import serialization

    from mav_detection_tpu.models import pretrained as jpre

    return jpre._migrate_raft_state(serialization.msgpack_restore(SHIPPED.read_bytes()))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def test_soup_endpoints_and_middle_equal_the_reference(candidate_file):
    import jax

    from mav_detection_tpu.models import checkpoint as jck
    from mav_detection_tpu.models import pretrained as jpre

    shipped, cand = soup_raft.read_tree(str(SHIPPED)), soup_raft.read_tree(str(candidate_file))
    assert soup_raft.leaf_dtypes(str(SHIPPED)) == {"float32": 92}
    for alpha, end in ((0.0, shipped), (1.0, cand)):
        got = dict(_flat(soup_raft.soup_tree(shipped, cand, alpha)))
        for k, v in _flat(end):
            np.testing.assert_array_equal(got[k], v, err_msg=str(k))
    like = _jax_template()
    js = jck.load_msgpack(str(SHIPPED), like, migrate=jpre._migrate_raft_state)
    jc = jck.load_msgpack(str(candidate_file), like, migrate=jpre._migrate_raft_state)
    want = jax.tree_util.tree_map(lambda a, b: (1.0 - 0.5) * a + 0.5 * b, js, jc)
    got = dict(_flat(soup_raft.soup_tree(shipped, cand, 0.5)))
    flat_want = dict(_flat(want))
    assert sorted(got) == sorted(flat_want)
    for k, v in flat_want.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=str(k))


@pytest.mark.parametrize("alpha", [0.3, 0.5, 0.7])
def test_soup_rounds_bfloat16_leaves_as_numpy_does(tmp_path, rng, alpha):
    """A bfloat16 leaf, read from its file, soups as numpy with ml_dtypes
    (the reference's tree_map over numpy leaves) soups it: widened to fp32,
    the result fp32, against an fp32 leaf and against a bfloat16 one."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    a32 = rng.normal(size=(64,)).astype(np.float32)
    a16 = a32.astype(ml_dtypes.bfloat16)
    b16 = rng.normal(size=(64,)).astype(ml_dtypes.bfloat16)

    def t16(x):
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)

    path = checkpoint.save_msgpack(str(tmp_path / "t.msgpack"),
                                   {"a32": a32, "a16": t16(a16), "b16": t16(b16)})
    tree = checkpoint.load_msgpack(path)
    for a, ta in ((a32, tree["a32"]), (a16, tree["a16"])):
        want = (1.0 - alpha) * a + alpha * b16
        got = soup_raft.soup_leaf(ta, tree["b16"], alpha)
        assert want.dtype == got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_bfloat16_leaves_round_trip_through_the_reader(tmp_path, rng):
    """The reader widens a bfloat16 leaf to fp32 exactly, and the soup's
    dtype report reads the leaves' dtypes from the file."""
    tree = {"params": {"a": torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32)
                                             ).to(torch.bfloat16),
                       "b": rng.normal(size=(2,)).astype(np.float32)}}
    path = checkpoint.save_msgpack(str(tmp_path / "t.msgpack"), tree)
    assert soup_raft.leaf_dtypes(path) == {"bfloat16": 1, "float32": 1}
    plain = checkpoint.load_msgpack(path)
    assert plain["params"]["a"].dtype == np.float32
    np.testing.assert_array_equal(plain["params"]["a"], tree["params"]["a"].float().numpy())
    np.testing.assert_array_equal(plain["params"]["b"], tree["params"]["b"])


def test_soup_main_keeps_the_best_passing_alpha(monkeypatch, tmp_path, candidate_file, capsys):
    """The lowest worst-case drone EPE among the passing alphas wins and is
    written; a failing alpha never does."""
    drone = {0.3: 0.62, 0.5: 0.45, 0.7: 0.4}     # the mock simulator's drone EPE

    def evaluate(model, scene=None, detection=True):
        if not detection:
            return dict(BASE)
        a = next(alphas)
        return dict(CANDS["failing" if a == 0.7 else "passing"], sim_drone_epe=drone[a])

    alphas = iter([0.3, 0.5, 0.7])
    monkeypatch.setattr(finetune_raft, "evaluate", evaluate)
    out = tmp_path / "soup.msgpack"
    res = soup_raft.main(["--candidate", str(candidate_file), "--out", str(out)],
                         device="cpu")
    assert [r["all_pass"] for r in res["alphas"]] == [True, True, False]
    assert res["best_alpha"] == 0.5 and res["shipped_to"] is None
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["best_alpha"] == 0.5
    want = dict(_flat(soup_raft.soup_tree(soup_raft.read_tree(str(SHIPPED)),
                                          soup_raft.read_tree(str(candidate_file)), 0.5)))
    for k, v in _flat(checkpoint.load_msgpack(str(out))):
        np.testing.assert_array_equal(v, want[k])


# --------------------------------------------------------------- curriculum
def _fake_phases(monkeypatch, calls, fail_at=None):
    """finetune_raft.main replaced by a run that writes its candidate (and
    raises at ``fail_at``, as a killed phase would end)."""

    def fake(argv, device=None, scene=None):
        args = dict(zip(argv[::2], argv[1::2]))
        calls.append(argv)
        Path(args["--candidate"]).write_bytes(b"weights " + args["--pan-max"].encode())
        if fail_at is not None and len(calls) == fail_at:
            raise KeyboardInterrupt("killed")
        return {"candidate": {"eval_epe": float(args["--pan-max"])},
                "gates": {"g": False}, "all_pass": False, "shipped_to": None}

    monkeypatch.setattr(finetune_raft, "main", fake)


def test_curriculum_runs_the_shell_scripts_phases(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("MAV_CHECKPOINT_PATH", str(tmp_path / "ck"))
    calls = []
    _fake_phases(monkeypatch, calls)
    res = pan_curriculum.main(["--dir", str(tmp_path), "--steps", "3"], device="cpu")
    d = str(tmp_path)
    assert calls == [
        ["--pan-max", "12", "--steps", "3", "--lr", "8e-05", "--sin-blend", "0.6",
         "--candidate", f"{d}/phase1.msgpack.partial"],
        ["--pan-max", "6", "--steps", "3", "--lr", "4e-05", "--sin-blend", "0.6",
         "--candidate", f"{d}/phase2.msgpack.partial", "--init", f"{d}/phase1.msgpack"],
        ["--pan-max", "9", "--steps", "3", "--lr", "3e-05", "--sin-blend", "0.85",
         "--candidate", f"{d}/phase3.msgpack.partial", "--init", f"{d}/phase2.msgpack",
         "--ship"]]
    for n in (1, 2, 3):
        assert (tmp_path / f"phase{n}.done").exists()
        assert (tmp_path / f"phase{n}.msgpack").exists()
        assert not (tmp_path / f"phase{n}.msgpack.partial").exists()
    assert [p["skipped"] for p in res["phases"]] == [False] * 3
    assert [p["evals"]["eval_epe"] for p in res["phases"]] == [12.0, 6.0, 9.0]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["steps"] == 3


def test_curriculum_reruns_a_killed_phase_and_skips_finished_ones(monkeypatch, tmp_path):
    monkeypatch.setenv("MAV_CHECKPOINT_PATH", str(tmp_path / "ck"))
    calls = []
    _fake_phases(monkeypatch, calls, fail_at=2)
    with pytest.raises(KeyboardInterrupt):
        pan_curriculum.main(["--dir", str(tmp_path), "--steps", "3"], device="cpu")
    assert (tmp_path / "phase1.done").exists() and not (tmp_path / "phase2.done").exists()
    # a killed phase leaves what the trainer wrote, never a sentinel; the
    # shell script would have skipped a phase whose candidate exists
    (tmp_path / "phase2.msgpack").write_bytes(b"half-trained")
    calls.clear()
    _fake_phases(monkeypatch, calls)
    res = pan_curriculum.main(["--dir", str(tmp_path), "--steps", "3"], device="cpu")
    assert [c[c.index("--candidate") + 1] for c in calls] == [
        f"{tmp_path}/phase2.msgpack.partial", f"{tmp_path}/phase3.msgpack.partial"]
    assert [p["skipped"] for p in res["phases"]] == [True, False, False]
    assert (tmp_path / "phase2.msgpack").read_bytes() == b"weights 6"
    calls.clear()
    res = pan_curriculum.main(["--dir", str(tmp_path), "--steps", "3"], device="cpu")
    assert calls == [] and [p["skipped"] for p in res["phases"]] == [True] * 3

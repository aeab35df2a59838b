"""chip_smoke.py: every phase at a tiny size on the CPU, the four-card
phases on four virtual CPU devices, and the script's contract (no result
without a GPU, without ``nvidia-smi`` or outside a checkout)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs
from nllstpu.core import optimize as opt

TINY = dict(
    ladybug=dict(ncameras=8, npoints=120, seed=1, noise=1e-3,
                 track_alpha=2.3),
    flagship=dict(ncameras=6, nlandmarks=60, prop_visible=0.5, noise=1e-3),
    dubrovnik=dict(ncameras=10, npoints=200, seed=1, noise=1e-3,
                   track_alpha=2.0),
    realistic=dict(ncameras=10, npoints=180, seed=3, noise=1e-3,
                   track_alpha=2.0),
    iters=8, large_iters=3, shard_iters=5,
)
SCRIPT = cs.__file__


def _assert_ok(rec):
    assert rec["ok"], rec["checks"]
    json.dumps(rec)  # every record prints as one JSON line


@pytest.fixture(scope="module")
def direct_record():
    return cs.phase_direct_f32(jax.devices()[0], TINY["ladybug"],
                               TINY["iters"])


def test_phase_direct_f32(direct_record):
    _assert_ok(direct_record)
    assert direct_record["dtype"] == "float32"
    assert direct_record["iterations"] == TINY["iters"]


def test_phase_reference_f64(direct_record):
    rec = cs.phase_reference_f64(jax.devices()[0], TINY["ladybug"],
                                 TINY["iters"], direct_record)
    _assert_ok(rec)
    assert set(rec["checks"]) == set(cs.TOLERANCES) - {
        "implicit_over_direct", "sharded_vs_single_rel"
    }
    assert rec["lambda"] > 0
    assert rec["dense_dim"] == 8 * 9 + 120 * 3


def test_phase_implicit_f32(direct_record):
    _assert_ok(cs.phase_implicit_f32(jax.devices()[0], TINY["ladybug"],
                                     TINY["iters"], direct_record))


def test_phase_flagship_f32():
    _assert_ok(cs.phase_flagship_f32(jax.devices()[0], TINY["flagship"],
                                     TINY["iters"]))


def test_phase_large_routes_implicit(monkeypatch):
    """Past the dense-W budget ``solver="schur"`` compiles implicit, and
    the phase sees it; under the budget its routing check fails."""
    dev = jax.devices()[0]
    monkeypatch.setattr(opt, "DENSE_W_BYTE_LIMIT", 1000)
    _assert_ok(cs.phase_large_f32(dev, TINY["dubrovnik"], TINY["large_iters"]))
    monkeypatch.setattr(opt, "DENSE_W_BYTE_LIMIT", 1 << 40)
    rec = cs.phase_large_f32(dev, TINY["dubrovnik"], TINY["large_iters"])
    assert not rec["checks"]["routed_implicit"]["ok"] and not rec["ok"]


def test_four_shard_shapes():
    rec = cs.phase_shard_shapes(jax.devices()[:4], TINY["realistic"])
    _assert_ok(rec)
    assert rec["landmark_slots"] % 4 == 0


@pytest.mark.parametrize("solver", ["schur", "schur_cg"])
def test_four_sharded_f64(solver):
    rec = cs.phase_sharded_f64(jax.devices()[:4], TINY["realistic"],
                               TINY["shard_iters"], solver)
    _assert_ok(rec)
    assert rec["phase"] == f"four_sharded_{solver}_f64"


def test_result_line_has_exactly_the_contract_keys():
    line = json.loads(json.dumps(cs.result_line(jax.devices()[:1])))
    assert set(line) == {"ok", "device"} and line["ok"] is True
    assert set(line["device"]) == {"platform", "kind", "count"}
    assert line["device"]["count"] == 1
    assert cs.result_line(jax.devices()[:4])["device"]["count"] == 4


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        cs.require_gpu()
    assert "no GPU" in str(e.value.code)


def test_query_card_needs_nvidia_smi(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(SystemExit) as e:
        cs.query_card()
    assert "nvidia-smi not found" in str(e.value.code)


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_script_exits_nonzero_on_cpu():
    proc = _run(SCRIPT, os.path.dirname(SCRIPT))
    assert proc.returncode != 0
    assert "no GPU found" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_script_alone_exits_nonzero(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SCRIPT, alone)
    proc = _run(str(alone), tmp_path)
    assert proc.returncode != 0
    assert "checkout" in proc.stderr
    assert '"ok"' not in proc.stdout


@pytest.mark.gpu
def test_phases_1_2_on_gpu(gpu):
    """Phases 1 and 2 at a tiny size on the card (``-m gpu``)."""
    rec = cs.phase_direct_f32(gpu, TINY["ladybug"], TINY["iters"])
    _assert_ok(rec)
    _assert_ok(cs.phase_reference_f64(gpu, TINY["ladybug"], TINY["iters"],
                                      rec))

"""Benchmark plumbing that needs no card: the peak table, the compile-cache
placement and the trace reduction of benchmarks/profile_step.py."""

import os

import jax
import pytest

import bench
from benchmarks import profile_step as ps
from mujoco_sim_tpu.utils import cache


def test_peaks_of_h100():
    pk = bench.peaks("NVIDIA H100 80GB HBM3")
    assert pk == {"bf16_flops": 989e12, "tf32_flops": 495e12,
                  "f32_flops": 67e12, "hbm_bytes": 3.35e12}


@pytest.mark.parametrize("kind", ["cpu", "", "NVIDIA H100 PCIe",
                                  "Some Future Card"])
def test_peaks_refuse_unknown_device_kind(kind):
    with pytest.raises(ValueError, match="no peak rates"):
        bench.peaks(kind)


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        bench.require_gpu()


def test_unknown_scenario_is_refused():
    with pytest.raises(SystemExit, match="unknown scenario"):
        bench.main(["no_such_scenario"])


@pytest.fixture
def restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_compile_cache_from_environment(monkeypatch, tmp_path,
                                        restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.compile_cache_dir() == str(tmp_path)
    assert cache.use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    assert (jax.config.jax_persistent_cache_min_compile_time_secs
            == cache.MIN_COMPILE_SECS)


def test_compile_cache_defaults_to_repo(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert cache.compile_cache_dir() == want
    cache.use_compile_cache()
    assert jax.config.jax_compilation_cache_dir == want


def _ev(start, dur, op="fusion.1"):
    return {"name": op, "start": start, "dur": dur, "hlo_op": op}


def test_busy_is_union_of_kernel_intervals():
    evs = [_ev(0, 10), _ev(5, 10), _ev(30, 5), _ev(31, 2), _ev(40, 0)]
    assert ps.busy_ns(evs) == 20
    assert ps.window_ns(evs) == 40
    assert ps.busy_ns([]) == 0


def test_stage_attribution_from_hlo_metadata():
    hlo = "\n".join([
        '  %fusion.1 = f32[4]{0} fusion(f32[4]{0} %p), kind=kLoop, '
        'metadata={op_name="jit(run)/while/body/vmap()/collision/mtv/add"}',
        '  ROOT %loop_fusion.2 = f32[4]{0} fusion(f32[4]{0} %p), '
        'metadata={op_name="jit(run)/solver/while/body/dot_general" '
        'source_file="x.py"}',
        '  %copy.3 = f32[4]{0} copy(f32[4]{0} %p)',
    ])
    names = ps.hlo_op_names(hlo)
    assert set(names) == {"fusion.1", "loop_fusion.2"}
    assert ps.stage_of(names["fusion.1"]) == "mtv"
    assert ps.stage_of(names["loop_fusion.2"]) == "solver"
    assert ps.stage_of("jit(run)/while/body/add") == "other"
    evs = [_ev(0, 3, "fusion.1"), _ev(5, 4, "loop_fusion.2"),
           _ev(9, 1, "copy.3")]
    assert ps.stage_breakdown(evs, names) == {"mtv": 3, "solver": 4,
                                              "other": 1}


@pytest.mark.parametrize("n", [6, 42])
def test_chol_forms_agree_and_patch_is_undone(n):
    """profile_step's Cholesky A/B: both forms solve the same SPD system
    inside a jitted vmap, and the engine's own form is back afterwards."""
    import jax.numpy as jnp
    import numpy as np

    from mujoco_sim_tpu.ops import linalg

    rng = np.random.default_rng(n)
    a = rng.standard_normal((3, n, n))
    spd = jnp.asarray(a @ np.swapaxes(a, -1, -2) + n * np.eye(n))
    rhs = jnp.asarray(rng.standard_normal((3, n)))

    def solve(A, b):
        return linalg.cho_solve(linalg.cholesky(A), b)

    own = linalg.cholesky, linalg.cho_solve
    want = np.linalg.solve(np.asarray(spd), np.asarray(rhs)[..., None])
    for form in ps.CHOL_FORMS:
        with ps.chol_form(form):
            assert (linalg.cholesky is own[0]) == (form == "unrolled")
            x = jax.jit(jax.vmap(solve))(spd, rhs)
        np.testing.assert_allclose(np.asarray(x), want[..., 0], rtol=1e-9,
                                   atol=1e-9)
    assert (linalg.cholesky, linalg.cho_solve) == own


def test_unknown_chol_form_is_refused():
    with pytest.raises(SystemExit, match="unknown Cholesky form"):
        with ps.chol_form("magma"):
            pass


@pytest.mark.gpu
def test_card_is_in_peak_table(gpu):
    info = bench.device_info()
    assert info["platform"] == "gpu" and info["count"] >= 1
    assert bench.peaks(gpu.device_kind)["hbm_bytes"] > 0
    assert bench.require_gpu() == gpu


@pytest.mark.gpu
def test_box_rollout_on_card_matches_cpu(gpu):
    """The smoke scene (a free box dropped on the floor) rolled out on the
    card and on the CPU backend, f32 at "highest" matmul precision: the
    two differ only by the order of floating-point sums."""
    import jax.numpy as jnp
    import numpy as np

    from mujoco_sim_tpu import engine
    from mujoco_sim_tpu.models.compile import load_model

    m = engine.put_model(load_model("tests/fixtures/floor_box.xml"),
                         jnp.float32)
    d = engine.make_data(m, jnp.float32)
    dB = jax.tree.map(lambda x: jnp.broadcast_to(x, (8,) + x.shape), d)
    dB = dB.replace(qpos=dB.qpos.at[:, 2].add(jnp.linspace(0.0, 0.3, 8)))
    run = bench._rollout_fn(50)
    out = {}
    for dev in (gpu, jax.devices("cpu")[0]):
        q = run(jax.device_put(m, dev), jax.device_put(dB, dev)).qpos
        assert q.devices() == {dev}
        out[dev.platform] = np.asarray(q)
    assert np.isfinite(out["gpu"]).all()
    np.testing.assert_allclose(out["gpu"], out["cpu"], atol=1e-4)

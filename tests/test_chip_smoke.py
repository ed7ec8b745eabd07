"""chip_smoke.py's contract where no GPU exists, the compile-cache location,
the trace-to-stage reduction, and import hygiene for one-process-per-card."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, env=None, cwd=ROOT, timeout=240):
    e = {k: v for k, v in os.environ.items()
         if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    e.update(env or {})
    return subprocess.run([sys.executable] + args, cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("where", ["checkout", "script_alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """On the CPU, and in a directory holding only chip_smoke.py, the
    script exits non-zero and prints no result line."""
    cwd = ROOT
    if where == "script_alone":
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    out = _run(["chip_smoke.py"], env={"JAX_PLATFORMS": "cpu"}, cwd=cwd)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_result_line_has_exactly_the_contract_keys():
    sys.path.insert(0, ROOT)
    import chip_smoke

    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([Dev()])
    assert "\n" not in line
    obj = json.loads(line)
    assert obj == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


_CACHE_PROBE = ("import jax; from msf_loam_tpu.core import cache; "
                "print(cache.enable_compilation_cache(), "
                "jax.config.jax_compilation_cache_dir)")


def test_cache_follows_jax_compilation_cache_dir(tmp_path):
    out = _run(["-c", _CACHE_PROBE],
               env={"JAX_PLATFORMS": "cpu",
                    "JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", str(tmp_path)]


def test_cache_defaults_to_repo_jax_cache():
    out = _run(["-c", _CACHE_PROBE], env={"JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", os.path.join(ROOT, ".jax_cache")]


def test_stage_times_attributes_ops_to_named_stages(tmp_path):
    """chip_smoke's trace reduction on a small recorded trace: ops land in
    the stage their name scope says, busy time is positive."""
    probe = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {ROOT!r})
        import jax, jax.numpy as jnp
        import chip_smoke

        @jax.jit
        def jit_fused_probe(x):
            with jax.named_scope("pick_rounds"):
                y = jnp.sort(jnp.sin(x) * 3.0, axis=1)
            with jax.named_scope("select_fit"):
                z = y @ x.T
            return z.sum()

        x = jnp.ones((256, 256))
        jit_fused_probe(x).block_until_ready()
        with jax.profiler.trace({str(tmp_path / 'tr')!r}):
            jit_fused_probe(x).block_until_ready()
        st = chip_smoke.stage_times({str(tmp_path / 'tr')!r},
                                    {str(tmp_path / 'hlo')!r}, 1)
        print(json.dumps(st))
    """)
    out = _run(["-c", probe], env={
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": f"--xla_dump_to={tmp_path / 'hlo'} "
                     "--xla_dump_hlo_as_text "
                     "--xla_dump_hlo_module_re=jit_jit_fused_probe"})
    assert out.returncode == 0, out.stderr[-3000:]
    st = json.loads(out.stdout.strip().splitlines()[-1])
    stages = st["stage_ms_per_frame"]
    assert stages.get("extract: pick rounds", 0) > 0
    assert stages.get("map: select/fit", 0) > 0
    assert st["device_busy_ms_per_frame"] > 0
    assert 0.0 <= st["idle_share_of_span"] < 1.0


def test_importing_the_package_initialises_no_backend():
    """A process that only imports the package (scripts/stream_producer.py
    feeding ``run_slam --listen``) must not open the accelerator: JAX
    reserves most of a card's memory for the first process that does."""
    probe = ("import glob, importlib\n"
             "for p in sorted(glob.glob('msf_loam_tpu/**/*.py', "
             "recursive=True)):\n"
             "    if not p.endswith('_pb2.py'):  # generated on demand\n"
             "        importlib.import_module(p[:-3].replace('/', '.')"
             ".replace('.__init__', ''))\n"
             "import runpy\n"
             "runpy.run_path('scripts/stream_producer.py', run_name='probe')\n"
             "from jax._src import xla_bridge\n"
             "print(sorted(xla_bridge._backends))\n")
    out = _run(["-c", probe], env={"JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"

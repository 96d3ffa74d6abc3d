"""No module the harness loads has the top-level name jax, jaxlib, flax or
adaptive_sph_tpu, and none the reference loads has those or
adaptive_sph_torch; names are compared whole (adaptive_sph_torch begins with
adaptive_sph_t...). Each check runs in a fresh process."""

import json
import subprocess
import sys

import tiny

HARNESS = ("jax", "jaxlib", "flax", "adaptive_sph_tpu")
REFERENCE = HARNESS + ("adaptive_sph_torch",)

PROBE = """
import json, sys
sys.path.insert(0, {bench!r}); sys.path.append({root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(body: str) -> set:
    code = PROBE.format(bench=str(tiny.BENCH), root=str(tiny.ROOT), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(tiny.ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program_or_jax():
    top = loaded("import reference.step\nfrom reference.step import Reference")
    assert "reference" in top
    assert not top & set(REFERENCE), top & set(REFERENCE)


def test_a_whole_run_loads_no_jax(tmp_path):
    root = tiny.make_root(tmp_path, episode_steps=2, trace_steps=1)
    body = (f"from benchlib import harness\nfrom benchlib.spec import Spec\n"
            f"harness.run('tiny-stress', 5, 0.5, True, spec=Spec({str(root)!r}), "
            f"device='cpu')\n"
            "assert harness.forbidden_modules() == []\n")
    top = loaded(body)
    assert "adaptive_sph_torch" in top and "reference" in top
    assert not top & set(HARNESS), top & set(HARNESS)


def test_the_guard_compares_whole_names(monkeypatch):
    from benchlib import harness

    monkeypatch.setitem(sys.modules, "adaptive_sph_tpux", sys)
    assert "adaptive_sph_tpux" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in harness.forbidden_modules()

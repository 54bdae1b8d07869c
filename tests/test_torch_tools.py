"""The port's experiment tools and batch mesh extraction against the JAX
package's, on the CPU, on one experiments tree copied for each side.

* ``tools/cleanup.py``: ``gc_experiments`` removes the same files (and the
  dry run removes none), and ``main --dry_run`` prints the same lines.
* ``tools/transfer.py``: ``collect_files`` picks the same files in the same
  order, and ``main --dry_run`` prints the same rsync commands.
* ``scripts/extract_all_meshes.py``: with ``subprocess.run`` replaced by a
  recorder, the same runs are selected (those with ``runconf.conf`` and
  ``checkpoints/latest.ckpt``) and ``cli/eval.py`` gets the same flags, the
  module name aside; the port's ``--data_root`` defaults to ``data``.

No JAX subprocess is started and nothing is compiled. The file takes well
under a second of CPU alone.
"""

import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import monosdf_tpu.tools.cleanup as jclean
import monosdf_tpu.tools.transfer as jtransfer
import monosdf_torch.tools as ttools
import monosdf_torch.tools.cleanup as tclean
import monosdf_torch.tools.transfer as ttransfer
from monosdf_torch.scripts import extract_all_meshes as textract

REPO = Path(__file__).resolve().parent.parent


def _exps(root: Path) -> Path:
    """Three runs: a, with 6 numbered checkpoints, latest.ckpt, plots of 4
    epochs, runconf.conf and metrics.jsonl; b, with checkpoints but no
    runconf.conf; c, with runconf.conf but no latest.ckpt; and a stray
    file. The files' times are set one second apart in the order written."""
    t = [1_000_000]

    def touch(p: Path, text="x"):
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
        t[0] += 1
        os.utime(p, (t[0], t[0]))

    for i in (5, 10, 15, 20, 25, 30):
        touch(root / "a" / "checkpoints" / f"{i}.ckpt")
    touch(root / "a" / "checkpoints" / "latest.ckpt")
    for ep in (1, 2, 3, 4):
        touch(root / "a" / "plots" / f"surface_{ep}.ply")
        touch(root / "a" / "plots" / f"rendering_{ep}.png")
    touch(root / "a" / "runconf.conf", "train{}")
    touch(root / "a" / "metrics.jsonl")
    for i in (1, 2):
        touch(root / "b" / "checkpoints" / f"{i}.ckpt")
    touch(root / "b" / "checkpoints" / "latest.ckpt")
    touch(root / "c" / "runconf.conf", "train{}")
    touch(root / "c" / "checkpoints" / "3.ckpt")
    touch(root / "stray.txt")
    return root


def _tree(root: Path) -> list:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _copies(tmp_path):
    a = _exps(tmp_path / "jax" / "exps")
    b = tmp_path / "port" / "exps"
    shutil.copytree(a, b)
    for p in a.rglob("*"):  # copytree keeps the times; make sure
        q = b / p.relative_to(a)
        st = p.stat()
        os.utime(q, (st.st_atime, st.st_mtime))
    return a, b


@pytest.mark.parametrize("dry_run", [True, False])
def test_gc_experiments_removes_the_same_files(tmp_path, dry_run):
    a, b = _copies(tmp_path)
    rj = jclean.gc_experiments(str(a), keep_ckpt=2, keep_plots=1, dry_run=dry_run)
    rt = ttools.gc_experiments(str(b), keep_ckpt=2, keep_plots=1, dry_run=dry_run)
    rel = lambda rep, root: {k: [os.path.relpath(p, root) for p in v] for k, v in rep.items()}
    assert rel(rt, b) == rel(rj, a) and rj
    assert _tree(b) == _tree(a)
    assert (len(_tree(a)) == len(_tree(b))) and (dry_run == ("a/checkpoints/5.ckpt" in _tree(a)))


def test_cleanup_and_transfer_mains_print_the_same(tmp_path, monkeypatch, capsys):
    a, b = _copies(tmp_path)
    outs = []
    for mod, root, call in ((jclean, a, None), (tclean, b, None)):
        monkeypatch.setattr(sys, "argv", ["cleanup", "--exps_root", str(root), "--dry_run"])
        mod.main()
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "would remove" in outs[0]

    for x, y in zip(jtransfer.collect_files(str(a / "a")), ttransfer.collect_files(str(b / "a"))):
        assert os.path.relpath(x, a) == os.path.relpath(y, b)
    assert len(ttransfer.collect_files(str(b / "a"), all_plys=True)) == 2 + 2 + 4
    outs = []
    for mod, root in ((jtransfer, a), (ttransfer, b)):
        monkeypatch.setattr(sys, "argv", ["transfer", "--run", str(root / "a"),
                                          "--dest", "host:/exps", "--dry_run"])
        mod.main()
        outs.append(capsys.readouterr().out.replace(str(root), "ROOT"))
    assert outs[0] == outs[1] and outs[0].count("rsync -a --mkpath") == 5


def test_extract_all_meshes_selects_the_same_runs(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location("jax_extract_all_meshes",
                                                  REPO / "scripts" / "extract_all_meshes.py")
    jextract = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jextract)
    a, b = _copies(tmp_path)
    calls = []

    class Done:
        returncode = 0

    def recorder(cmd, *args, **kw):
        calls.append(list(cmd))
        return Done()

    monkeypatch.setattr(subprocess, "run", recorder)
    cmds = {}
    for side, mod, root in (("jax", jextract, a), ("port", textract, b)):
        calls.clear()
        argv = ["--exps_root", str(root), "--data_root", "scenes", "--out_dir",
                str(tmp_path / side / "meshes"), "--resolution", "256", "--world_space"]
        if side == "jax":
            monkeypatch.setattr(sys, "argv", ["extract_all_meshes.py", *argv])
            mod.main()
        else:
            assert mod.main(argv) == 1
        cmds[side] = [[c.replace(str(root), "EXPS").replace(str(tmp_path / side), "OUT")
                       for c in cmd] for cmd in calls]
    assert len(cmds["jax"]) == 1 and "EXPS/a/runconf.conf" in cmds["jax"][0]
    j, t = cmds["jax"][0], cmds["port"][0]
    assert j[j.index("-m") + 1] == "monosdf_tpu.cli.eval"
    assert t[t.index("-m") + 1] == "monosdf_torch.cli.eval"
    assert j[j.index("-m") + 2:] == t[t.index("-m") + 2:]

    calls.clear()
    textract.main(["--exps_root", str(b), "--out_dir", str(tmp_path / "m2"), "--device", "cpu"])
    assert calls[0][calls[0].index("--data_root") + 1] == "data"
    assert calls[0][-2:] == ["--device", "cpu"]

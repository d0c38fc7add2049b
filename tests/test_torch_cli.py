"""The port's console entry points (``cli.py``) against the JAX
package's, on the repository's drive recipe: the simulator CLI, then
``infer_scrt_main`` (the pert level with clone discovery, then
``--level clone``), then ``infer_spf_main``, each package over its own
TSV files, the port with ``--device cpu``.  The outputs carry the same
columns; the port's also meet the recovery bars.
"""

import subprocess
import sys
from pathlib import Path

import pandas as pd
import pytest

from scdna_replication_tools_tpu import cli as jcli
from scdna_replication_tools_tpu_torch import cli as tcli

from test_torch_model import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SIM = ["-n", "50000", "-l", "0.75", "-a", "10", "-b", "0.5", "0.0", "-rt",
       "rt_A", "rt_B", "-c", "A", "B"]
# the JAX run needs its own caches off; the port accepts the same flags
COMMON = ["--max-iter", "120", "--telemetry", "none", "--compile-cache",
          "none"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, synthetic_frames):
    df_s, df_g = synthetic_frames
    out = {}
    for name, cli, extra in (("jax", jcli, []),
                             ("torch", tcli, ["--device", "cpu"])):
        d = tmp_path_factory.mktemp(f"cli_{name}")
        df_s.to_csv(d / "in_s.tsv", sep="\t", index=False)
        df_g.to_csv(d / "in_g.tsv", sep="\t", index=False)
        cli.simulator_main(["-si", str(d / "in_s.tsv"), "-gi",
                            str(d / "in_g.tsv"), *SIM, "-so",
                            str(d / "sim_s.tsv"), "-go", str(d / "sim_g.tsv"),
                            *extra])
        for part in ("sim_s", "sim_g"):
            df = pd.read_csv(d / f"{part}.tsv", sep="\t", dtype={"chr": str})
            df["reads"] = df["true_reads_norm"]
            df["state"] = df["true_somatic_cn"].astype(int)
            df["copy"] = df["true_somatic_cn"].astype(float)
            df.drop(columns=["clone_id"]).to_csv(d / f"pert_{part}.tsv",
                                                 sep="\t", index=False)
        ins = [str(d / "pert_sim_s.tsv"), str(d / "pert_sim_g.tsv")]
        cli.infer_scrt_main(ins + [str(d / "out.tsv"), str(d / "supp.tsv"),
                                   "--clone-col", "none", *COMMON, *extra])
        cli.infer_scrt_main(ins + [str(d / "clone.tsv"),
                                   str(d / "clone_supp.tsv"), "--clone-col",
                                   "none", "--level", "clone", *extra])
        cli.infer_spf_main(ins + [str(d / "spf_s.tsv"), str(d / "spf.tsv"),
                                  "--clone-col", "none", *extra])
        out[name] = d
    return out


@pytest.mark.parametrize("name", ["sim_s", "sim_g", "out", "supp", "clone",
                                  "spf_s", "spf"])
def test_outputs_carry_jax_columns(runs, name):
    j = pd.read_csv(runs["jax"] / f"{name}.tsv", sep="\t", nrows=5)
    t = pd.read_csv(runs["torch"] / f"{name}.tsv", sep="\t", nrows=5)
    assert list(t.columns) == list(j.columns)


def test_port_cli_meets_the_recovery_bars(runs):
    out = pd.read_csv(runs["torch"] / "out.tsv", sep="\t")
    assert (out["model_rep_state"] == out["true_rep"]).mean() > 0.80
    assert (out["model_cn_state"] == out["true_somatic_cn"]).mean() > 0.90
    clone = pd.read_csv(runs["torch"] / "clone.tsv", sep="\t")
    assert set(clone["rt_state"].unique()) <= {0.0, 1.0}


def test_unported_flags_raise_naming_the_roadmap(runs, monkeypatch):
    d = runs["torch"]
    ins = [str(d / "pert_sim_s.tsv"), str(d / "pert_sim_g.tsv"),
           str(d / "x.tsv"), str(d / "y.tsv"), "--device", "cpu"]
    # ported (A12): two cell shards need a process group of two ranks
    with pytest.raises(ValueError, match="init_distributed"):
        tcli.infer_scrt_main(ins + ["--num-shards", "2"])
    with pytest.raises(ValueError, match="enum_impl"):
        tcli.infer_scrt_main(ins + ["--enum-impl", "pallas"])
    # ported (A14, A11b): the store, build and profile flags reach scRT
    from scdna_replication_tools_tpu_torch import api

    class Reached(Exception):
        pass

    seen = {}

    def fake_scrt(*args, **kwargs):
        seen.update(kwargs)
        raise Reached
    monkeypatch.setattr(api, "scRT", fake_scrt)
    with pytest.raises(Reached):
        tcli.infer_scrt_main(ins + ["--executable-cache", str(d / "ec"),
                                    "--compile-cache", "none",
                                    "--profile-dir", str(d / "prof")])
    assert seen["executable_cache_dir"] == str(d / "ec")
    assert seen["compile_cache_dir"] is None
    assert seen["profile_dir"] == str(d / "prof")


def test_cli_module_imports_no_jax():
    code = ("import sys\n"
            "import scdna_replication_tools_tpu_torch.cli\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'scdna_replication_tools_tpu' "
            "or m.startswith('scdna_replication_tools_tpu.')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"

"""The port's figure runner as a user calls it: ``benchmarks/pt_run.py``
runs a ported figure and the collective microbenchmark on the CPU when
asked, and refuses a name it does not know."""
import pytest

pytest.importorskip("torch")

from benchmarks import pt_run  # noqa: E402


def test_pt_run_fig1_on_cpu_and_refuses_unported(tmp_path, capsys):
    assert pt_run.main(["--only", "fig1", "--quick", "--device", "cpu",
                        "--cache-dir", str(tmp_path)]) == 0
    assert (tmp_path / "fig1_breakdown.csv").exists()
    assert "fig1[1048576]" in capsys.readouterr().out
    assert pt_run.main(["--only", "collectives", "--device", "cpu",
                        "--cache-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "8 ranks over gloo on cpu" in out and "collectives[2097152]" in out
    with open(tmp_path / "collective_bench.csv") as f:
        head = f.readline()
    assert "ring_all_reduce_kernel2" in head and "native_all_gather" in head
    with pytest.raises(SystemExit):
        pt_run.main(["--only", "nope"])
    assert "unknown" in capsys.readouterr().err
    assert "scenarios" in pt_run.PORTED and "faults" in pt_run.PORTED


def test_drivers_default_to_the_card():
    import torch

    from benchmarks import pt_fig1_breakdown, pt_fig3_sawtooth

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt_run.main(["--only", "fig1", "--quick"])
    with pytest.raises(RuntimeError, match="CUDA"):
        pt_fig1_breakdown.run_sizes([2 ** 20])
    with pytest.raises(RuntimeError, match="CUDA"):
        pt_fig3_sawtooth.run_points([("haicgu_ib", 2 ** 20)])

"""The port's figure runner as a user calls it: ``benchmarks/pt_run.py``
runs a ported figure on the CPU when asked, and refuses, naming the
ROADMAP item, a name the port does not run yet."""
import pytest

pytest.importorskip("torch")

from benchmarks import pt_run  # noqa: E402


def test_pt_run_fig1_on_cpu_and_refuses_unported(tmp_path, capsys):
    assert pt_run.main(["--only", "fig1", "--quick", "--device", "cpu",
                        "--cache-dir", str(tmp_path)]) == 0
    assert (tmp_path / "fig1_breakdown.csv").exists()
    assert "fig1[1048576]" in capsys.readouterr().out
    for name in ("collectives",):
        assert pt_run.main(["--only", name]) != 0
        assert "ROADMAP" in capsys.readouterr().err
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

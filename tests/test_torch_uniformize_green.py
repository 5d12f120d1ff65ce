"""cmtci_torch's uniformize-green pipeline and CLI against cmtci's, live on
the CPU.

Both packages get the same input points (the reference's
export_lucas_boundary at n_max 40, 300 points) at n_bdy 200 and 500 interior
points, in both polygon sources: the f64 diagnostics row within 1e-9
relative (abs 1e-12 on the inverse-check errors, which sit at rounding
level, and on g_bdy_in_median and bdy_resid_median, which are 0 by
construction), the radii histogram counts equal, the map state within
1e-9; the f32 run within the reference's f32 budget; the fit cache; the
subcommand and its session defaults. The full-width row (n_bdy 2000, 20,000
interior points) is marked slow.
"""

import csv
import json

import numpy as np
import pytest
import torch

from cmtci.pipelines import uniformize_green as ref
from cmtci.pipelines.lucas_boundary import LucasBoundaryConfig, export_lucas_boundary
from cmtci_torch import cli
from cmtci_torch.maps import riemann
from cmtci_torch.pipelines import uniformize_green as green

#: diagnostics columns held by an absolute 1e-12 (see the module docstring)
ABS_COLUMNS = ("inverse_err_median", "inverse_err_p90", "inverse_err_max",
               "g_bdy_in_median", "bdy_resid_median")
SMALL = dict(n_bdy=200, interior_n=500)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's small tensors: the suite
    runs several pytest workers on the CPU at once, and each worker's
    OpenMP thread pool would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pts():
    return export_lucas_boundary(LucasBoundaryConfig(n_max=40, n_boundary=300))


def rows_close(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, str):
            assert g == w, key
        elif key in ABS_COLUMNS:
            assert abs(g - w) <= 1e-12, (key, g, w)
        else:
            assert abs(g - w) <= 1e-9 * abs(w), (key, g, w)


def read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module", params=["alpha", "ordered"])
def f64_runs(request, pts, tmp_path_factory):
    src = request.param
    d = tmp_path_factory.mktemp(f"green_{src}")
    want = ref.run_green_uniformization(
        pts, ref.GreenUniformizeConfig(polygon_source=src, **SMALL), str(d / "ref"))
    got = green.run_green_uniformization(
        pts, green.GreenUniformizeConfig(polygon_source=src, **SMALL), str(d / "port"),
        device="cpu")
    return src, want, got, d


def test_f64_diagnostics_match_the_reference(f64_runs):
    _, want, got, d = f64_runs
    rows_close(got["diagnostics"], want["diagnostics"])
    a, b = read_csv(d / "port" / "diagnostics.csv"), read_csv(d / "ref" / "diagnostics.csv")
    assert a[0] == b[0] and len(a) == len(b) == 2


def test_f64_files_match_the_reference(f64_runs):
    _, _, _, d = f64_runs
    assert read_csv(d / "port" / "radii_hist_w_raw.csv") == read_csv(
        d / "ref" / "radii_hist_w_raw.csv")
    assert (d / "port" / "meta.txt").read_text() == (d / "ref" / "meta.txt").read_text()
    zp, zr = np.load(d / "port" / "map_state.npz"), np.load(d / "ref" / "map_state.npz")
    assert sorted(zp.files) == sorted(zr.files)
    for key in zr.files:
        a, b = zp[key], zr[key]
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if key == "inverse_err":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12, err_msg=key)


def test_f32_run_within_the_reference_budget(pts, f64_runs):
    src, want, _, _ = f64_runs
    got = green.run_green_uniformization(
        pts, green.GreenUniformizeConfig(polygon_source=src, map_dtype="float32", **SMALL),
        device="cpu")
    np.testing.assert_array_equal(got["interior"], want["interior"])
    d = got["diagnostics"]
    assert abs(d["bdy_mod_median"] - 1.0) < 1e-3
    w64 = want["disk"]
    w32 = got["disk"]
    assert np.quantile(np.abs(np.angle(w32 / w64)), 0.99) < 1e-3
    assert np.quantile(np.abs(np.abs(w32) - np.abs(w64)), 0.99) < 1e-3
    # the qr32 fit (tests/test_maps.py:225-239)
    assert np.abs(got["map"].sigma - want["map"].sigma).max() < 1e-5
    assert abs(got["map"].c - want["map"].c) < 1e-8
    assert abs(d["g_shift"] - want["diagnostics"]["g_shift"]) < 1e-6


def test_fit_cache_round_trip(pts, tmp_path, monkeypatch):
    cfg = green.GreenUniformizeConfig(**SMALL)
    first = green.run_green_uniformization(pts, cfg, cache_dir=str(tmp_path), device="cpu")
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == 1 and files[0].startswith("riemann_fit_")

    def no_fit(*a, **k):
        raise AssertionError("the cached fit was not read")

    monkeypatch.setattr(riemann, "fit_riemann_map", no_fit)
    second = green.run_green_uniformization(pts, cfg, cache_dir=str(tmp_path), device="cpu")
    assert second["diagnostics"] == first["diagnostics"]
    np.testing.assert_array_equal(second["disk"], first["disk"])


def test_fit_cache_key_names_the_implementation(pts, tmp_path):
    """A cache directory shared with cmtci never hands one package's fit to
    the other: the two write different entries."""
    ref.run_green_uniformization(pts, ref.GreenUniformizeConfig(**SMALL),
                                 cache_dir=str(tmp_path))
    green.run_green_uniformization(pts, green.GreenUniformizeConfig(**SMALL),
                                   cache_dir=str(tmp_path), device="cpu")
    assert len([p for p in tmp_path.iterdir() if p.name.startswith("riemann_fit_")]) == 2


def test_stage_times_and_unknown_options(pts):
    from cmtci_torch.utils.artifacts import StageTimer

    timer = StageTimer("cpu")
    out = green.run_green_uniformization(pts, green.GreenUniformizeConfig(**SMALL),
                                         timer=timer, device="cpu")
    assert list(out["stage_times"]) == ["polygon", "fit+interior_sample", "phi_f_eval",
                                        "diagnostics"]
    with pytest.raises(ValueError, match="polygon_source"):
        green.run_green_uniformization(
            pts, green.GreenUniformizeConfig(polygon_source="hull", **SMALL), device="cpu")


def test_cli_writes_the_reference_files(pts, tmp_path, capsys):
    np.save(tmp_path / "lucas.npy", pts)
    cli.main(["uniformize-green", "--device", "cpu", "--lucas-npy", str(tmp_path / "lucas.npy"),
              "--n-bdy", "200", "--interior-n", "500", "--out", str(tmp_path / "out")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(line) == sorted(k for k in ref.run_green_uniformization(
        pts, ref.GreenUniformizeConfig(**SMALL))["diagnostics"]
        if k.startswith(("bdy_mod", "inverse_err")))
    assert abs(line["bdy_mod_median"] - 1.0) < 1e-3
    for name in ("meta.txt", "diagnostics.csv", "radii_hist_w_raw.csv", "map_state.npz"):
        assert (tmp_path / "out" / name).exists(), name
    assert "map_dtype=float64" in (tmp_path / "out" / "meta.txt").read_text()


@pytest.mark.parametrize("argv,want", [
    ([], "float32"), (["--parity"], "float64"), (["--device", "cpu"], "float64"),
    (["--map-dtype", "float64"], "float64"), (["--parity", "--map-dtype", "float32"], "float32"),
])
def test_cli_session_defaults(argv, want):
    args = cli._parser().parse_args(["uniformize-green", *argv])
    cli._resolve_platform_defaults(args)
    assert args.map_dtype == want


def test_cli_rejects_trace_dir(capsys):
    """The reference's --trace-dir is the port's too now (parsed, one trace a
    stage); a flag the reference lacks here still fails in argparse."""
    assert cli._parser().parse_args(["uniformize-green", "--trace-dir", "t"]).trace_dir == "t"
    with pytest.raises(SystemExit) as exc:
        cli.main(["uniformize-green", "--device", "cpu", "--mesh-devices", "2"])
    assert exc.value.code == 2
    assert "--mesh-devices" in capsys.readouterr().err


def test_cuda_without_card_raises(pts):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        green.run_green_uniformization(pts, green.GreenUniformizeConfig(**SMALL))
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["uniformize-green", "--n-bdy", "200", "--interior-n", "500"])


@pytest.mark.slow
def test_full_width_f64_matches_the_reference(tmp_path):
    """The defaults (n_bdy 2000, 20,000 interior points) on the default
    export_lucas_boundary input, both packages fed the same points."""
    full = export_lucas_boundary(LucasBoundaryConfig())
    want = ref.run_green_uniformization(full, ref.GreenUniformizeConfig())
    torch.set_num_threads(4)
    got = green.run_green_uniformization(full, green.GreenUniformizeConfig(), device="cpu")
    rows_close(got["diagnostics"], want["diagnostics"])
    np.testing.assert_allclose(got["disk"], want["disk"], rtol=1e-9, atol=1e-12)

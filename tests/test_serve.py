"""Serving endpoint: health, models, trace, error paths."""
import json
import threading
import urllib.request

import pytest

from raytracing_tpu.serve import create_server


@pytest.fixture(scope="module")
def server():
    srv = create_server("127.0.0.1", 0)
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{port}"
    srv.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, json.loads(r.read())


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_healthz(server):
    code, body = _get(server + "/healthz")
    assert code == 200 and body["status"] == "ok"


def test_models(server):
    code, body = _get(server + "/v1/models")
    assert code == 200
    assert "fisheye" in body["scenarios"] and "op6" in body["ops"]
    assert "op12" in body["extensions"]


def test_trace_fisheye(server):
    code, body = _post(server + "/v1/trace",
                       {"scenario": "fisheye", "op": "op6", "rays": 256,
                        "delta_s": 2 * 3.141592653589793 / 64, "divisor": 64})
    assert code == 200, body
    assert body["engine"] in ("fused", "golden", "scan")
    assert body["closure_error_pct"] < 5.0
    assert body["ray_steps_per_sec"] > 0


def test_trace_bad_request(server):
    code, body = _post(server + "/v1/trace", {"scenario": "warp"})
    assert code == 400 and "warp" in body["error"]
    code, body = _post(server + "/v1/trace", {"rays": -5})
    assert code == 400
    code, body = _post(server + "/v1/nope", {})
    assert code == 404


def test_trace_high_precision(server):
    code, body = _post(server + "/v1/trace",
                       {"scenario": "fisheye", "op": "op12", "rays": 128,
                        "delta_s": 2 * 3.141592653589793 / 200,
                        "divisor": 200, "precision": "high"})
    assert code == 200, body
    assert body["engine"] == "df32"
    assert body["closure_error_pct"] < 1e-4


def test_trace_hostile_payloads_rejected(server):
    """Resource-exhaustion vectors must 400, not hang or kill the thread."""
    # delta_s = 0 -> round(inf) previously OverflowError'd the handler thread
    code, body = _post(server + "/v1/trace",
                       {"scenario": "fisheye", "op": "op1", "delta_s": 0.0})
    assert code == 400 and "delta_s" in body["error"]
    # tiny delta_s -> unbounded step count
    code, body = _post(server + "/v1/trace",
                       {"scenario": "interface", "op": "op1", "delta_s": 1e-9})
    assert code == 400 and "steps" in body["error"]
    # NaN / negative delta_s
    for ds in (float("nan"), -1.0):
        code, body = _post(server + "/v1/trace",
                           {"scenario": "interface", "op": "op1", "delta_s": ds})
        assert code == 400
    # unbounded n_turns
    code, body = _post(server + "/v1/trace",
                       {"scenario": "fisheye", "op": "op1", "n_turns": 10**9})
    assert code == 400 and "n_turns" in body["error"]
    # non-numeric rays -> TypeError/ValueError path
    code, body = _post(server + "/v1/trace", {"rays": "many"})
    assert code == 400


def test_trace_stratified_medium(server):
    code, body = _post(server + "/v1/trace",
                       {"scenario": "interface", "op": "op6", "rays": 128,
                        "medium": "stratified"})
    assert code == 200, body
    assert body["medium"] == "stratified"
    assert body["engine"] in ("fused-strat-seg-skip", "scan")
    code, body = _post(server + "/v1/trace",
                       {"scenario": "fisheye", "medium": "stratified"})
    assert code == 400 and "x-independent" in body["error"]
    code, body = _post(server + "/v1/trace", {"medium": "banana"})
    assert code == 400


def test_trace_grid_medium(server):
    """medium=grid serves the reference's 2-D sampled-spline pipeline
    through the scan tier."""
    code, body = _post(server + "/v1/trace",
                       {"scenario": "fisheye", "op": "op6", "rays": 128,
                        "medium": "grid", "divisor": 100, "n_turns": 1})
    assert code == 200, body
    assert body["medium"] == "grid"
    assert body["engine"] == "scan"


def test_trace_c1_media(server):
    """The consistent-gradient family serves through the same endpoint."""
    code, body = _post(server + "/v1/trace",
                       {"scenario": "fisheye", "op": "op6", "rays": 128,
                        "medium": "c1", "divisor": 100, "n_turns": 1})
    assert code == 200, body
    assert body["medium"] == "c1"
    assert body["engine"] == "scan"
    code, body = _post(server + "/v1/trace",
                       {"scenario": "vert", "op": "op8", "rays": 128,
                        "medium": "c1-stratified"})
    assert code == 200, body
    assert body["engine"] == "fused-strat-seg-skip"
    code, body = _post(server + "/v1/trace",
                       {"scenario": "fisheye", "medium": "c1-stratified"})
    assert code == 400 and "x-independent" in body["error"]


def _lens_samples():
    import numpy as np
    gx = np.linspace(-2.0, 2.0, 41)
    gy = np.linspace(-1.5, 1.5, 31)
    Z = 1.0 / (1.0 + 0.4 * gx[None, :] ** 2 + 0.6 * gy[:, None] ** 2)
    return Z.tolist(), gx.tolist(), gy.tolist()


def test_trace_samples_grid(server):
    """POSTed measured 2-D grids trace through both families."""
    Z, gx, gy = _lens_samples()
    req = {"samples": Z, "x": gx, "y": gy, "op": "op6",
           "delta_s": 0.01, "steps": 60, "rays": 256,
           "launch": {"x": -1.5, "y": [-0.3, 0.3], "theta": 0.0},
           "return_positions": True}
    code, body = _post(server + "/v1/trace_samples", req)
    assert code == 200, body
    assert body["medium_kind"] == "grid" and body["family"] == "parity"
    assert len(body["pos"]) == 256 and len(body["active"]) == 256
    code, c1 = _post(server + "/v1/trace_samples", dict(req, family="c1"))
    assert code == 200, c1
    assert c1["family"] == "c1"
    # same samples, same fan: the two families agree to interpolant grade
    import numpy as np
    d = np.abs(np.asarray(body["pos"]) - np.asarray(c1["pos"])).max()
    assert d < 5e-3, d


def test_trace_samples_profile(server):
    """A 1-D measured profile serves through the stratified family."""
    import numpy as np
    y = np.linspace(-2.0, 1.0, 61)
    col = 1.0 + 0.3 * np.tanh(2.0 * y)
    req = {"samples": col.tolist(), "y": y.tolist(), "op": "op6",
           "family": "c1", "delta_s": 0.01, "steps": 80, "rays": 128,
           "box": [-5.0, 5.0, -2.0, 1.0],
           "launch": {"x": 0.0, "y": [-1.5, -0.5], "theta": 0.3}}
    code, body = _post(server + "/v1/trace_samples", req)
    assert code == 200, body
    assert body["medium_kind"] == "profile"
    assert body["ray_steps_per_sec"] > 0
    assert "pos" not in body            # return_positions defaults off


def test_trace_samples_rejected(server):
    Z, gx, gy = _lens_samples()
    base = {"samples": Z, "x": gx, "y": gy, "delta_s": 0.01, "steps": 10,
            "launch": {"x": 0.0, "y": [-0.1, 0.1]}}
    for mutate, frag in (
            (dict(family="cubic"), "family"),
            ({"samples": [[1.0, float("nan")] * 2] * 4}, "finite"),
            (dict(delta_s=-1.0), "delta_s"),
            (dict(steps=0), "steps"),
            ({"launch": None, "rays": 8}, "pos0"),
            (dict(steps=10, rays=0), "rays"),
            (dict(box=[0.0, 1.0]), "box"),
            ({"samples": [1.0, 2.0, 3.0], "y": [0.0, 1.0, 2.0]},
             "at least 4"),
            (dict(rays=70000, return_positions=True), "caps"),
            ({"launch": {"x": 0.0, "y": []}}, "non-empty"),
            ({"y": list(reversed(gy))}, "ascending"),
            (dict(box=[0.0, 1.0, 5.0, -5.0]), "ordered"),
    ):
        code, body = _post(server + "/v1/trace_samples",
                           dict(base, **mutate))
        assert code == 400, (mutate, body)
        assert frag in body["error"], (frag, body["error"])
    # delta_s genuinely required (no calibrated table for user media)
    code, body = _post(server + "/v1/trace_samples",
                       {"samples": Z, "x": gx, "y": gy, "steps": 10,
                        "launch": {"x": 0.0, "y": [-0.1, 0.1]}})
    assert code == 400 and "delta_s" in body["error"]


def test_calibrate_samples(server):
    """Self-convergence calibration over HTTP, then trace at the result."""
    import numpy as np
    y = np.linspace(-2.0, 1.0, 61)
    col = (1.0 + 0.3 * np.tanh(2.0 * y)).tolist()
    req = {"samples": col, "y": y.tolist(), "op": "op6", "family": "c1",
           "arc_length": 1.0, "tol": 1e-2, "rays": 128,
           "candidates": [0.1, 0.05, 0.025],
           "box": [-5.0, 5.0, -2.0, 1.0],
           "launch": {"x": 0.0, "y": [-1.5, -0.5], "theta": 0.3}}
    code, body = _post(server + "/v1/calibrate_samples", req)
    assert code == 200, body
    assert body["accepted"] and body["delta_s"] in req["candidates"]
    assert body["halving_err"][0] is not None
    # trace at the calibrated step through the sibling endpoint
    code, tr = _post(server + "/v1/trace_samples",
                     dict(req, delta_s=body["delta_s"],
                          steps=body["steps"]))
    assert code == 200, tr
    assert tr["ray_steps_per_sec"] > 0

    for mutate, frag in ((dict(arc_length=-1.0), "arc_length"),
                         (dict(tol=0.0), "tol"),
                         (dict(candidates=[0.1] * 17), "caps at 16"),
                         (dict(candidates=[0.1, -0.2]), "positive"),
                         (dict(rays=70000), "rays must be in [1, 65536]")):
        code, body = _post(server + "/v1/calibrate_samples",
                           dict(req, **mutate))
        assert code == 400, (mutate, body)
        assert frag in body["error"], (frag, body["error"])


def test_concurrent_requests(server):
    """The ThreadingHTTPServer claim under load: parallel requests across
    DIFFERENT endpoints all complete correctly (jit caches are shared and
    thread-safe; no cross-request state)."""
    import numpy as np
    import concurrent.futures as cf

    y = np.linspace(-2.0, 1.0, 61)
    col = (1.0 + 0.3 * np.tanh(2.0 * y)).tolist()
    jobs = [
        ("/v1/trace", {"scenario": "fisheye", "op": "op6", "rays": 128,
                       "delta_s": 2 * np.pi / 64, "divisor": 64}),
        ("/v1/trace", {"scenario": "fisheye", "op": "op1", "rays": 128,
                       "delta_s": 2 * np.pi / 64, "divisor": 64}),
        ("/v1/trace_samples",
         {"samples": col, "y": y.tolist(), "op": "op6", "family": "c1",
          "delta_s": 0.01, "steps": 60, "rays": 128,
          "box": [-5.0, 5.0, -2.0, 1.0],
          "launch": {"x": 0.0, "y": [-1.5, -0.5], "theta": 0.3}}),
        ("/v1/trace", {"scenario": "interface", "op": "op6", "rays": 128,
                       "medium": "stratified"}),
    ] * 2
    with cf.ThreadPoolExecutor(8) as ex:
        results = list(ex.map(
            lambda j: _post(server + j[0], j[1]), jobs))
    for (code, body), (path, req) in zip(results, jobs):
        assert code == 200, (path, body)
        assert body["ray_steps_per_sec"] > 0
        if req.get("scenario") == "fisheye":
            assert body["closure_error_pct"] < 5.0, body


def test_models_advertises_endpoints(server):
    code, body = _get(server + "/v1/models")
    assert code == 200
    assert "/v1/trace_samples" in body["endpoints"]
    assert "/v1/calibrate_samples" in body["endpoints"]
    assert body["sample_families"] == ["parity", "c1"]


@pytest.mark.slow
def test_fuzzed_payloads_never_5xx(server):
    """Structured fuzz over every POST endpoint: whatever the body, the
    server answers 200/400 — never a 5xx and never a dropped connection
    (the production contract the error-tuple in do_POST implements)."""
    import numpy as np

    rng = np.random.default_rng(42)
    scalars = [0, -1, 1e308, -1e308, float("inf"), float("nan"), "x",
               None, True, [], {}, "op6", 1e-300, 2**62]
    keys = ["scenario", "op", "rays", "delta_s", "divisor", "n_turns",
            "steps", "medium", "precision", "samples", "x", "y", "family",
            "launch", "pos0", "theta0", "box", "gamma", "tol",
            "arc_length", "candidates", "return_positions",
            "source", "receivers", "fan", "omega"]

    def rand_value(depth=0):
        r = rng.integers(0, 6 if depth < 2 else 4)
        if r == 0:
            return scalars[rng.integers(len(scalars))]
        if r == 1:
            return float(rng.normal(0, 10))
        if r == 2:
            return int(rng.integers(-5, 100))
        if r == 3:
            return [float(v) for v in rng.normal(0, 2, rng.integers(0, 5))]
        if r == 4:
            return [rand_value(depth + 1)
                    for _ in range(rng.integers(0, 4))]
        return {k: rand_value(depth + 1)
                for k in rng.choice(keys, rng.integers(0, 4),
                                    replace=False)}

    endpoints = ["/v1/trace", "/v1/trace_samples", "/v1/calibrate_samples",
                 "/v1/eigenrays", "/v1/trace3d_samples", "/v1/eigenrays3"]
    for i in range(80):
        body = {k: rand_value()
                for k in rng.choice(keys, rng.integers(0, 6), replace=False)}
        # keep accidental valid-and-huge configs cheap
        body.setdefault("rays", 8)
        body["steps"] = min(int(body.get("steps", 8))
                            if isinstance(body.get("steps"), (int, float))
                            and np.isfinite(float(body.get("steps", 8)))
                            else 8, 64)
        code, resp = _post(server + endpoints[i % len(endpoints)], body)
        assert code in (200, 400), (code, body, resp)


def test_trace_samples_conservation_report(server):
    """report_conservation on a posted profile: full-batch CV(p_x) from
    the kernel's Welford tracker, below the reference's 0.05 % bar."""
    import numpy as np
    y = np.linspace(-1.5, 1.5, 61)
    col = 1.2 - 0.25 * y * y
    req = {"samples": col.tolist(), "y": y.tolist(), "op": "op6",
           "family": "c1", "delta_s": 0.01, "steps": 80, "rays": 128,
           "box": [-1e6, 1e6, -1.5, 1.5], "report_conservation": True,
           "launch": {"x": 0.0, "y": [-0.1, 0.1], "theta": 0.3}}
    code, body = _post(server + "/v1/trace_samples", req)
    assert code == 200, body
    assert body["momentum_cv_pct_max"] < 0.05, body
    # 2-D media: p_x is not an invariant -> named rejection
    Z, gx, gy = _lens_samples()
    code, body = _post(server + "/v1/trace_samples",
                       {"samples": Z, "x": gx, "y": gy, "delta_s": 0.01,
                        "steps": 10, "report_conservation": True,
                        "launch": {"x": 0.0, "y": [-0.1, 0.1]}})
    assert code == 400 and "profile" in body["error"]


def test_trace_samples_conservation_perpendicular_fan(server):
    """A fan launched at theta ~ pi/2 has p_x ~ 0: the CV report must stay
    valid strict JSON (null or non-negative values, never Infinity/NaN or
    a negative 'max' that silently reports the BEST-conserved ray)."""
    import numpy as np
    y = np.linspace(-1.5, 1.5, 61)
    col = 1.2 - 0.25 * y * y
    req = {"samples": col.tolist(), "y": y.tolist(), "op": "op6",
           "family": "c1", "delta_s": 0.01, "steps": 80, "rays": 128,
           "box": [-1e6, 1e6, -1.5, 1.5], "report_conservation": True,
           "launch": {"x": 0.0, "y": [-0.1, 0.1],
                      "theta": 1.5707963267948966}}
    code, body = _post(server + "/v1/trace_samples", req)
    assert code == 200, body
    # strict JSON: the payload must survive allow_nan=False re-serialization
    json.dumps(body, allow_nan=False)
    for k in ("momentum_cv_pct_mean", "momentum_cv_pct_max"):
        assert body[k] is None or body[k] >= 0, body


def test_calibrate_samples_hostile_ray_count_rejected_cheaply(server):
    """The calibration cap is enforced BEFORE the fan is allocated: a
    hostile count far above the cap gets the same named 400."""
    import numpy as np
    y = np.linspace(-1.0, 1.0, 31)
    req = {"samples": (1.3 - 0.1 * y * y).tolist(), "y": y.tolist(),
           "rays": 16777216, "arc_length": 1.0,
           "launch": {"x": 0.0, "y": [-0.1, 0.1], "theta": 0.2}}
    code, body = _post(server + "/v1/calibrate_samples", req)
    assert code == 400 and "65536" in body["error"], body


def test_eigenrays_endpoint(server):
    """Boundary-value arrivals through a posted waveguide profile, with
    per-receiver incoherent and (given omega) coherent TL."""
    import numpy as np
    y = np.linspace(-1.5, 1.5, 61)
    col = 1.2 - 0.25 * y * y                  # index max on the axis
    req = {"samples": col.tolist(), "y": y.tolist(), "op": "op6",
           "family": "c1", "delta_s": 0.02, "steps": 520,
           "box": [-1.0, 10.0, -1.5, 1.5],
           "source": [0.0, 0.0], "receivers": [[8.0, 0.0], [8.0, 0.3]],
           "fan": {"theta": [-0.45, 0.45], "count": 96}, "omega": 40.0}
    code, body = _post(server + "/v1/eigenrays", req)
    assert code == 200, body
    assert body["medium_kind"] == "profile" and body["fan_count"] == 96
    arr = body["arrivals"]
    assert len(arr) >= 2
    assert all(a["converged"] for a in arr)
    assert all(abs(a["y_err"]) < 1e-6 for a in arr)
    assert {a["receiver"] for a in arr} == {0, 1}
    # arrivals sorted by receiver then travel time
    keys = [(a["receiver"], a["traveltime"]) for a in arr]
    assert keys == sorted(keys)
    assert len(body["incoherent_tl_db"]) == 2
    assert all(v is not None for v in body["incoherent_tl_db"])
    assert len(body["coherent_tl_db"]) == 2


def test_eigenrays3_endpoint(server):
    """3-D boundary-value arrivals (the /v1/eigenrays twin): a lifted
    waveguide profile, a direction-grid fan, per-receiver TL."""
    import numpy as np
    y = np.linspace(-1.5, 1.5, 61)
    col = 1.2 - 0.25 * y * y
    req = {"samples": col.tolist(), "y": y.tolist(), "op": "op6",
           "family": "c1", "delta_s": 0.02, "steps": 320,
           "box": [-1.0, 10.0, -1.5, 1.5, -5.0, 5.0],
           "source": [0.0, 0.0, 0.0],
           "receivers": [[4.0, 0.0, 0.0], [4.0, 0.2, 0.1]],
           "fan": {"alpha": [-0.35, 0.35], "beta": [-0.35, 0.35],
                   "count": [17, 17]}, "omega": 40.0}
    code, body = _post(server + "/v1/eigenrays3", req)
    assert code == 200, body
    assert body["medium_kind"] == "profile-3d"
    assert body["fan_count"] == [17, 17]
    arr = body["arrivals"]
    assert len(arr) >= 2
    assert {a["receiver"] for a in arr} == {0, 1}
    assert all(a["converged"] for a in arr)
    assert all(a["miss"] < 1e-6 for a in arr)
    keys = [(a["receiver"], a["traveltime"]) for a in arr]
    assert keys == sorted(keys)
    assert len(body["incoherent_tl_db"]) == 2
    assert all(v is not None for v in body["incoherent_tl_db"])
    assert len(body["coherent_tl_db"]) == 2


def test_eigenrays3_rejects_bad_shapes(server):
    import numpy as np
    y = np.linspace(-1.0, 1.0, 21)
    base = {"samples": (1.2 - 0.1 * y * y).tolist(), "y": y.tolist(),
            "delta_s": 0.05, "steps": 40, "source": [0.0, 0.0, 0.0],
            "receivers": [[1.0, 0.0, 0.0]], "box": [-1, 2, -1, 1, -1, 1]}
    code, body = _post(server + "/v1/eigenrays3",
                       dict(base, source=[0.0, 0.0]))
    assert code == 400 and "source" in body["error"]
    code, body = _post(server + "/v1/eigenrays3",
                       dict(base, receivers=[[1.0, 0.0]]))
    assert code == 400 and "receivers" in body["error"]
    code, body = _post(server + "/v1/eigenrays3",
                       dict(base, fan={"alpha": [0.5, -0.5]}))
    assert code == 400
    # 2-D samples are the planar pipeline's job
    code, body = _post(server + "/v1/eigenrays3",
                       dict(base, samples=[[1.0, 1.1], [1.0, 1.1]]))
    assert code == 400 and "PROFILES" in body["error"]
    # budget bound: fan grid * steps capped (64M compute bound, round 5)
    code, body = _post(server + "/v1/eigenrays3",
                       dict(base, steps=100000,
                            fan={"count": [32, 32]}))
    assert code == 400 and "bound" in body["error"]


def test_eigenrays_rejects_golden_and_bad_shapes(server):
    import numpy as np
    y = np.linspace(-1.0, 1.0, 21)
    base = {"samples": (1.2 - 0.1 * y * y).tolist(), "y": y.tolist(),
            "delta_s": 0.05, "steps": 40, "source": [0.0, 0.0],
            "receivers": [[1.0, 0.0]], "box": [-1, 2, -1, 1]}
    code, body = _post(server + "/v1/eigenrays", dict(base, op="op5"))
    assert code == 400 and "golden" in body["error"]
    code, body = _post(server + "/v1/eigenrays",
                       dict(base, source=[0.0, 0.0, 1.0]))
    assert code == 400 and "source" in body["error"]
    code, body = _post(server + "/v1/eigenrays", dict(base, receivers=[]))
    assert code == 400 and "receivers" in body["error"]
    code, body = _post(server + "/v1/eigenrays",
                       dict(base, fan={"theta": [0.5, -0.5]}))
    assert code == 400
    # budget bound: fan * steps capped (the history-free solvers turned
    # the old 4M f64-history RAM cap into a 64M compute bound, round 5)
    code, body = _post(server + "/v1/eigenrays",
                       dict(base, steps=1000000,
                            fan={"theta": [-0.3, 0.3], "count": 512}))
    assert code == 400 and "bound" in body["error"]


def test_trace3d_samples_endpoint(server):
    """A posted 1-D profile traces in 3-D with the slowness-CV report."""
    import numpy as np
    y = np.linspace(-1.5, 1.5, 61)
    col = 1.2 - 0.25 * y * y
    req = {"samples": col.tolist(), "y": y.tolist(), "op": "op6",
           "family": "c1", "delta_s": 0.02, "steps": 300, "rays": 128,
           "box": [-1.0, 50.0, -1.5, 1.5, -50.0, 50.0],
           "launch": {"pos": [0.0, 0.0, 0.0], "axis": [1.0, 0.0, 0.2],
                      "half_angle": 0.2},
           "report_conservation": True}
    code, body = _post(server + "/v1/trace3d_samples", req)
    assert code == 200, body
    assert body["medium_kind"] == "profile-3d"
    assert body["rays"] == 128 and body["escaped_rays"] == 0
    assert body["slowness_cv_pct_max"] is not None
    assert body["slowness_cv_pct_max"] < 0.05   # the reference bar, in 3-D


def test_trace3d_samples_grid3_endpoint(server):
    """A posted 3-D measured grid traces through tri-Hermite tables
    (media/grid3.py) — the genuinely 3-D sampled-medium surface."""
    import numpy as np
    ax = np.linspace(-1.5, 1.5, 13)
    Zg, Yg, Xg = np.meshgrid(ax, ax, ax, indexing="ij")
    F = 1.2 - 0.1 * (Yg ** 2 + 0.3 * Xg * Zg)
    req = {"samples": F.tolist(), "x": ax.tolist(), "y": ax.tolist(),
           "z": ax.tolist(), "op": "op6", "delta_s": 0.02, "steps": 120,
           "rays": 64,
           "launch": {"pos": [-1.0, 0.0, 0.0], "axis": [1.0, 0.0, 0.1],
                      "half_angle": 0.15}}
    code, body = _post(server + "/v1/trace3d_samples", req)
    assert code == 200, body
    assert body["medium_kind"] == "grid3"
    assert body["rays"] == 64

    # 3-D grids exist only in the consistent-gradient family
    code, body = _post(server + "/v1/trace3d_samples",
                       dict(req, family="parity"))
    assert code == 400 and "c1" in body["error"]
    # missing axes
    bad = dict(req)
    del bad["z"]
    code, body = _post(server + "/v1/trace3d_samples", bad)
    assert code == 400


def test_trace3d_samples_rejections(server):
    import numpy as np
    y = np.linspace(-1.0, 1.0, 21)
    base = {"samples": (1.2 - 0.1 * y * y).tolist(), "y": y.tolist(),
            "delta_s": 0.05, "steps": 20,
            "launch": {"pos": [0, 0, 0], "axis": [1, 0, 0],
                       "half_angle": 0.1}}
    code, body = _post(server + "/v1/trace3d_samples",
                       dict(base, samples=[[1.0, 1.0], [1.0, 1.0]],
                            x=[0, 1]))
    assert code == 400 and "got 2-D samples" in body["error"]
    code, body = _post(server + "/v1/trace3d_samples", dict(base, op="op5"))
    assert code == 400 and "planar" in body["error"]
    code, body = _post(server + "/v1/trace3d_samples",
                       dict(base, launch={"pos": [0, 0], "axis": [1, 0, 0]}))
    assert code == 400
    code, body = _post(server + "/v1/trace3d_samples",
                       dict(base, box=[0, 1, 0, 1]))
    assert code == 400 and "box" in body["error"]


def test_eigenrays_on_device(server):
    """on_device=true: the split-word-evaluated profile + f32 device solve
    (engine/df_grid.DfEvalProfile; host CPU doubles as the 'device' under
    the test conftest) returns the same arrival structure as host/f64."""
    import numpy as np
    y = np.linspace(-1.5, 1.5, 61)
    col = 1.2 - 0.25 * y * y
    req = {"samples": col.tolist(), "y": y.tolist(), "op": "op6",
           "delta_s": 0.02, "steps": 520, "box": [-1.0, 10.0, -1.5, 1.5],
           "source": [0.0, 0.0], "receivers": [[8.0, 0.0], [8.0, 0.3]],
           "fan": {"theta": [-0.45, 0.45], "count": 96},
           "on_device": True}
    code, body = _post(server + "/v1/eigenrays", req)
    assert code == 200, body
    assert body["medium_kind"] == "df32-profile"
    arr = body["arrivals"]
    assert len(arr) >= 2 and all(a["converged"] for a in arr)
    assert all(abs(a["y_err"]) < 1e-4 for a in arr)   # f32 grade
    # 2-D grids stay on the host path
    req2 = dict(req)
    req2["samples"] = np.ones((8, 9)).tolist()
    req2["x"] = np.linspace(0, 1, 9).tolist()
    code, body = _post(server + "/v1/eigenrays", req2)
    assert code == 400 and "PROFILE" in body["error"]

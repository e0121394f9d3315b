"""Model serving: evaluate trained PINN checkpoints over HTTP.

The reference discards trained parameters when its training thread exits —
results exist only as plot .npz files (SURVEY §5 checkpoint row).  Here a
trained stage checkpoint (tpinn.utils.checkpoint, written by run_training)
can be re-loaded and served: batched u(z) / residual(z) queries evaluated
under jit on whatever accelerator is attached.

Run:  python -m tpinn.app.serve --checkpoint out/params_stage_1.npz \
          --problem annulus_laplace [--port 8060]

API:
    POST /predict   {"points": [[r, t], ...]}      -> {"u": [...]}
    POST /residual  {"points": [[r, t], ...]}      -> {"f": [...]}
    POST /uncertainty {"points": ...}  -> {"std": [...]}   (ensembles)
    GET  /health                                   -> {"ok": true, ...}

Queries are padded to fixed batch tiers (powers of two) so the jitted
evaluator compiles a handful of shapes, never per-request.
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np


class PINNServer:
    def __init__(self, checkpoint: str, problem_name: Optional[str] = None,
                 depth: Optional[int] = None, width: Optional[int] = None,
                 deflate: str = "off"):
        import jax
        import jax.numpy as jnp

        from tpinn import problems
        from tpinn.core import net, pde
        from tpinn.utils import checkpoint as ckpt

        self.jnp = jnp
        self.jax = jax
        self._coef = None

        # ensemble record (core.ensemble.run_ensemble_training output dir):
        # serve the convex combination of member checkpoints plus the
        # ensemble-level correction
        from pathlib import Path as _Path

        cpath = _Path(checkpoint)
        if cpath.is_dir() and (cpath / "ensemble.json").exists():
            cpath = cpath / "ensemble.json"
        if cpath.is_dir() and (cpath / "march.json").exists():
            cpath = cpath / "march.json"
        if cpath.name == "march.json":
            # time-marching record (core.march.run_time_marching): serve
            # the piecewise-in-time composite of the window checkpoints
            if problem_name is None:
                raise ValueError("march serving needs --problem")
            problem = problems.get_problem(problem_name)
            self.problem = problem
            self.compiled = pde.compile_pde(problem.equation, problem.coords)
            rec = json.loads(cpath.read_text())
            base = cpath.parent
            subs = [PINNServer(str(base / w), problem_name)
                    for w in rec["windows"]]

            from tpinn.core.march import make_march_predictor

            ai = int(rec["axis_index"])
            wpreds = tuple(s.predictor for s in subs)

            def predictor(params_list, z, _p=wpreds,
                          _mk=make_march_predictor, _e=tuple(rec["edges"])):
                fns = [lambda zz, fi=fi, pi=pi: fi(pi, zz)
                       for fi, pi in zip(_p, params_list)]
                return _mk(fns, _e, ai)(z)

            self.params = [s.params for s in subs]
            self.predictor = predictor
            self._predict = jax.jit(self.predictor)
            self._residual = jax.jit(
                lambda p, z: self.compiled.residual_fast(
                    self.predictor, p, z))
            return
        if cpath.name == "ensemble.json":
            if problem_name is None:
                raise ValueError("ensemble serving needs --problem")
            problem = problems.get_problem(problem_name)
            self.problem = problem
            self.compiled = pde.compile_pde(problem.equation, problem.coords)
            ens = json.loads(cpath.read_text())
            base = cpath.parent
            subs = [PINNServer(str(base / m), problem_name)
                    for m in ens["members"]]
            wts = [float(v) for v in ens["weights"]]
            preds = [s.predictor for s in subs]

            def predictor(params_list, z, _w=tuple(wts), _p=tuple(preds)):
                acc = None
                for wi, fi, pi in zip(_w, _p, params_list):
                    v = wi * fi(pi, z)
                    acc = v if acc is None else acc + v
                return acc

            if ens.get("deflation"):
                from tpinn.core.polish import deflation_term

                _term = deflation_term(ens["deflation"])
                _raw = predictor
                predictor = lambda p, z: _raw(p, z) - _term(z)
            def spread(params_list, z, _w=tuple(wts), _p=tuple(preds)):
                # weighted std across members — the epistemic band the
                # ensemble actually disagrees by (Σw = 1 convex weights)
                vals = [fi(pi, z) for fi, pi in zip(_p, params_list)]
                stack = jnp.stack(vals)
                w = jnp.asarray(_w)[:, None, None]
                mean = jnp.sum(w * stack, axis=0)
                var = jnp.sum(w * (stack - mean) ** 2, axis=0)
                return jnp.sqrt(var)

            self.params = [s.params for s in subs]
            self.predictor = predictor
            self._predict = jax.jit(self.predictor)
            self._spread = jax.jit(spread)
            self._residual = jax.jit(
                lambda p, z: self.compiled.residual_fast(
                    self.predictor, p, z))
            return

        # peek metadata for the architecture
        raw = np.load(checkpoint)
        meta = json.loads(bytes(raw["__meta__"]).decode()) if "__meta__" in raw \
            else {}
        sysm = meta.get("system")
        coefm = meta.get("coef") or {}
        if problem_name is not None:
            problem = problems.get_problem(problem_name)
        else:
            # self-describing checkpoint (run_system / run_inverse metas
            # carry the full problem record) — no preset needed
            if "coords" not in meta or "lb" not in meta:
                raise ValueError(
                    "--problem is required: this checkpoint's meta does not "
                    "describe its own domain/equation")
            from types import SimpleNamespace

            eq = (meta.get("equation")
                  or ("; ".join(sysm["equations"]) if sysm else ""))
            if not eq:
                raise ValueError(
                    "--problem is required: this (forward) checkpoint's "
                    "meta has no equation record")
            problem = SimpleNamespace(
                name=meta.get("problem", "checkpoint"),
                coords=tuple(meta["coords"]), dim=len(meta["coords"]),
                equation=eq,
                feature_kinds=tuple(meta.get("feature_kinds") or ()),
                lb=tuple(meta["lb"]), ub=tuple(meta["ub"]),
                source=None, bc_groups=(),
            )
        self.problem = problem
        coords = tuple(meta.get("coords", problem.coords))
        if sysm:
            # coupled system: residual has one column per equation
            self.compiled = pde.compile_system(
                sysm["equations"], coords, sysm["fields"],
                params=tuple(coefm))
        elif meta.get("inverse") and meta.get("equation"):
            # identified model: the equation's unknown coefficients are
            # evaluated at their RECOVERED values below
            self.compiled = pde.compile_pde(meta["equation"], coords,
                                            params=tuple(coefm))
        else:
            self.compiled = pde.compile_pde(problem.equation, problem.coords)
        if coefm:
            self._coef = {k: jnp.float32(v) for k, v in coefm.items()}
        if (sysm or coefm) and deflate != "off":
            raise ValueError(
                "--deflate targets scalar forward checkpoints; system/"
                "identified checkpoints have no spectral correction path")
        fm = net.feature_map_for(
            tuple(meta.get("feature_kinds") or problem.feature_kinds),
            pad_to=meta.get("pad_features", 0))
        lb = jnp.asarray(meta.get("lb", problem.lb))
        ub = jnp.asarray(meta.get("ub", problem.ub))
        if meta.get("patch"):
            # overlapping-patch checkpoint (core/patch.py): rebuild the
            # partition-of-unity predictor; params carry a leading P axis
            from tpinn.core.patch import (PatchSpec, init_patch_params,
                                          make_patch_predictor)

            pspec = PatchSpec(n=tuple(meta["patch"]["n"]),
                              overlap=float(meta["patch"]["overlap"]))
            mspec = net.spec_from_dict(meta["chain"][0])
            predictor = make_patch_predictor(
                mspec, pspec, np.asarray(lb), np.asarray(ub),
                pad_features=meta.get("pad_features", 0))
            template = init_patch_params(
                jax.random.PRNGKey(0), mspec, pspec,
                pad_features=meta.get("pad_features", 0))
        elif "chain" in meta:
            # rebuild the full multilevel chain exactly as trained — every
            # stage's act_first/scl/epsil comes from the saved spec, and the
            # composed params are the checkpoint's nested {"stage","prev"}
            # pytree (net.compose_stages threading)
            specs = [net.spec_from_dict(d) for d in meta["chain"]]
            predictor = net.make_predictor(specs[0], fm, lb, ub)
            template = net.init_params(jax.random.PRNGKey(0), specs[0], fm)
            for s in specs[1:]:
                predictor = net.compose_stages(predictor, s, fm, lb, ub)
                template = net.compose_params(
                    net.init_params(jax.random.PRNGKey(0), s, fm), template
                )
        else:
            # legacy checkpoint without a spec chain: infer a single plain
            # MLP from the layer shapes
            layer_keys = sorted(k for k in raw.files if k.endswith("/w"))
            widths = [raw[k].shape for k in layer_keys]
            spec = net.MLPSpec(
                depth=depth or (len(widths) - 1),
                width=width or widths[0][1],
                scl=float(meta.get("scl", 1.0)),
                epsil=float(meta.get("epsil", 1.0)),
            )
            template = net.init_params(jax.random.PRNGKey(0), spec, fm)
            predictor = net.make_predictor(spec, fm, lb, ub)
        if meta.get("hard_bc"):
            # rebuild the hard-BC ansatz around the raw chain (train.py
            # saves the expression strings in the checkpoint meta)
            coords = tuple(meta.get("coords", problem.coords))
            lift_fn, bubble_fn = (
                pde.compile_coord_expr(e, coords) for e in meta["hard_bc"]
            )
            predictor = net.wrap_hard_bc(predictor, lift_fn, bubble_fn)
        self.params, _ = ckpt.load_pytree(checkpoint, template)
        defl = meta.get("deflation")
        if not defl and deflate != "off":
            # retroactive correction: compute the spectral defect
            # correction for a checkpoint trained WITHOUT one (host f64,
            # one-time at load; the guards make it a no-op where it
            # cannot help).  Same dispatcher the trainer uses.
            import sys as _sys

            from tpinn.core import polish

            src = (pde.compile_coord_expr(problem.source, problem.coords)
                   if problem.source else None)
            defl = polish.defect_correction(
                predictor, self.params, self.compiled,
                problem.lb, problem.ub,
                tuple(meta["hard_bc"]) if meta.get("hard_bc") else None,
                mode=deflate, source_fn=src,
                coords=tuple(meta.get("coords", problem.coords)),
                bc_groups=problem.bc_groups,
            )
            print(f"[serve] deflate={deflate}: "
                  + (f"{defl['kind']} correction, {len(defl['modes'])} "
                     f"modes" if defl else "no applicable correction"),
                  file=_sys.stderr)
        if defl:
            # subtract the correction term (trained-run meta or the
            # retroactive solve above; train.py saves it JSON-safe)
            from tpinn.core.polish import deflation_term

            _term = deflation_term(defl)
            _raw = predictor
            predictor = lambda p, z: _raw(p, z) - _term(z)
        self.predictor = predictor
        self._predict = jax.jit(self.predictor)
        if hasattr(self.compiled, "residual_fast"):
            self._residual = jax.jit(
                lambda p, z: self.compiled.residual_fast(
                    self.predictor, p, z, self._coef)
            )
        else:
            # CompiledSystem: generic forward-mode residual, one column
            # per equation, coefficients at their recovered values
            self._residual = jax.jit(
                lambda p, z: self.compiled.residual(
                    lambda zz: self.predictor(p, zz), z, self._coef)
            )

    @staticmethod
    def _tier(n: int) -> int:
        t = 64
        while t < n:
            t *= 2
        return t

    def _eval(self, fn, points):
        jnp = self.jnp
        pts = np.asarray(points, dtype=np.float32)
        if pts.ndim != 2 or pts.shape[1] != self.problem.dim:
            raise ValueError(
                f"points must be [n, {self.problem.dim}] for "
                f"{self.problem.name}"
            )
        n = pts.shape[0]
        tier = self._tier(n)
        padded = np.zeros((tier, pts.shape[1]), np.float32)
        padded[:n] = pts
        padded[n:] = pts[-1] if n else 0.5
        out = np.asarray(fn(self.params, jnp.asarray(padded)))[:n]
        if out.ndim == 2 and out.shape[1] > 1:
            # coupled systems: one row per point (fields for /predict,
            # equation columns for /residual)
            return out.tolist()
        return out[:, 0].tolist()

    def predict(self, points):
        return self._eval(self._predict, points)

    def residual(self, points):
        return self._eval(self._residual, points)

    def uncertainty(self, points):
        """Per-point epistemic spread (weighted member std) — ensemble
        checkpoints only."""
        if getattr(self, "_spread", None) is None:
            raise ValueError("uncertainty needs an ensemble checkpoint "
                             "(serve an ensemble.json directory)")
        return self._eval(self._spread, points)


def make_handler(server: PINNServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                info = {"ok": True, "problem": server.problem.name,
                        "equation": server.problem.equation}
                if server._coef is not None:
                    info["coef"] = {k: float(v)
                                    for k, v in server._coef.items()}
                if hasattr(server.compiled, "fields"):
                    info["fields"] = list(server.compiled.fields)
                self._json(info)
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length))
                points = body["points"]
                if self.path == "/predict":
                    self._json({"u": server.predict(points)})
                elif self.path == "/residual":
                    self._json({"f": server.residual(points)})
                elif self.path == "/uncertainty":
                    self._json({"std": server.uncertainty(points)})
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:
                self._json({"error": str(e)}, 400)

    return Handler


def main():  # pragma: no cover
    p = argparse.ArgumentParser(description="serve a trained tpinn model")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--problem", default=None,
                   help="problem preset; optional for self-describing "
                        "checkpoints (run_inverse/run_system metas carry "
                        "their own domain + equations)")
    p.add_argument("--port", type=int, default=8060)
    # set BEFORE any device use
    p.add_argument("--platform", default=None,
                   help="force a jax platform, e.g. cpu")
    p.add_argument("--deflate", default="off",
                   choices=("off", "auto", "full"),
                   help="compute a spectral defect correction at load for "
                        "checkpoints trained without one (host f64; no-op "
                        "when a stored correction exists or none applies)")
    args = p.parse_args()
    import jax

    from tpinn.utils.compile_cache import enable_compile_cache

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    enable_compile_cache()
    server = PINNServer(args.checkpoint, args.problem, deflate=args.deflate)
    httpd = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(server))
    print(f"serving {args.problem} on :{args.port}")
    httpd.serve_forever()


if __name__ == "__main__":  # pragma: no cover
    main()

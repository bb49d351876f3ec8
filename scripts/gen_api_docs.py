"""Generate docs/api.md: every public symbol with its docstring's first line.

Reproducible reference page (run after API changes):
    python scripts/gen_api_docs.py
"""
import importlib
import inspect
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

MODULES = [
    "gigalens_tpu",
    "gigalens_tpu.config",
    "gigalens_tpu.simulator",
    "gigalens_tpu.model",
    "gigalens_tpu.prob.prior",
    "gigalens_tpu.prob.distributions",
    "gigalens_tpu.prob.bijectors",
    "gigalens_tpu.profiles.base",
    "gigalens_tpu.profiles.mass.epl",
    "gigalens_tpu.profiles.mass.sie",
    "gigalens_tpu.profiles.mass.shear",
    "gigalens_tpu.profiles.mass.nfw",
    "gigalens_tpu.profiles.mass.hernquist",
    "gigalens_tpu.profiles.mass.multipole",
    "gigalens_tpu.profiles.mass.point",
    "gigalens_tpu.profiles.mass.dpie",
    "gigalens_tpu.profiles.mass.scaling",
    "gigalens_tpu.profiles.mass.series",
    "gigalens_tpu.profiles.mass.dpie_subhalo",
    "gigalens_tpu.profiles.light.sersic",
    "gigalens_tpu.profiles.light.shapelets",
    "gigalens_tpu.profiles.light.gaussian",
    "gigalens_tpu.inversion",
    "gigalens_tpu.cosmology",
    "gigalens_tpu.inference.sequence",
    "gigalens_tpu.inference.survey",
    "gigalens_tpu.inference.map",
    "gigalens_tpu.inference.svi",
    "gigalens_tpu.inference.hmc",
    "gigalens_tpu.inference.smc",
    "gigalens_tpu.parallel.mesh",
    "gigalens_tpu.ops.psf",
    "gigalens_tpu.utils.diagnostics",
    "gigalens_tpu.utils.images",
    "gigalens_tpu.utils.summary",
    "gigalens_tpu.utils.checkpoint",
    "gigalens_tpu.utils.profiling",
]


def first_line(obj):
    doc = inspect.getdoc(obj)
    return doc.split("\n")[0].strip() if doc else ""


def main():
    lines = [
        "# API reference",
        "",
        "One line per public symbol (generated by `scripts/gen_api_docs.py`;",
        "see module docstrings for the full contracts and the measured",
        "rationale behind defaults).",
        "",
    ]
    for modname in MODULES:
        mod = importlib.import_module(modname)
        entries = []
        for name, obj in sorted(vars(mod).items()):
            if name.startswith("_"):
                continue
            if not (inspect.isclass(obj) or inspect.isfunction(obj)):
                continue
            if getattr(obj, "__module__", None) != modname:
                continue  # re-exports documented at their home module
            kind = "class" if inspect.isclass(obj) else "def"
            entries.append(f"- `{kind} {name}` — {first_line(obj)}")
            if inspect.isclass(obj):
                for mname, m in sorted(vars(obj).items()):
                    if mname.startswith("_") or not callable(m):
                        continue
                    fl = first_line(m)
                    if fl:
                        entries.append(f"  - `.{mname}()` — {fl}")
        if not entries:
            continue
        lines.append(f"## `{modname}`")
        fl = first_line(mod)
        if fl:
            lines.append(f"\n{fl}\n")
        lines.extend(entries)
        lines.append("")
    out = os.path.join(_REPO_ROOT, "docs", "api.md")
    with open(out, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {out}: {len(lines)} lines")


if __name__ == "__main__":
    main()

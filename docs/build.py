"""Build the static documentation site into docs/site/.

The reference ships a Documenter.jl + Literate.jl site (reference
docs/make.jl:1-60): model-formulation pages, a literated example, and
API docstrings.  This is the dependency-free equivalent for this
repo: python-markdown renders the hand-written pages, a small
Literate-style transform turns example scripts into prose+code pages,
and the API page is generated from the live package docstrings.

Run:  python docs/build.py        ->  docs/site/*.html
"""

import inspect
import os
import re
import sys

import markdown

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
SITE = os.path.join(HERE, "site")

PAGES = [
    # (source, output name, nav title)
    ("index.md", "index.html", "Home"),
    ("formulation.md", "formulation.html", "Model formulation"),
    ("architecture.md", "architecture.html", "Architecture"),
    ("parallelism.md", "parallelism.html", "Parallelism (DD)"),
    ("@literate:examples/bowl_mixing.py", "example_bowl_mixing.html",
     "Example: bowl mixing"),
    ("@literate:examples/sphere.py", "example_sphere.html",
     "Example: rotating ball"),
    ("@api", "api.html", "API reference"),
]

CSS = """
body { font-family: -apple-system, 'Segoe UI', Roboto, sans-serif;
       margin: 0; color: #1a1a1a; line-height: 1.55; }
.wrap { display: flex; min-height: 100vh; }
nav { width: 230px; flex-shrink: 0; background: #f4f6f8;
      border-right: 1px solid #dde3e8; padding: 1.2rem 0; }
nav h2 { font-size: 0.95rem; padding: 0 1.2rem; color: #456; }
nav a { display: block; padding: 0.35rem 1.2rem; color: #205080;
        text-decoration: none; font-size: 0.92rem; }
nav a.current { background: #e2ecf5; font-weight: 600; }
main { flex: 1; max-width: 54rem; padding: 1.5rem 2.5rem 4rem; }
pre { background: #f6f8fa; border: 1px solid #e3e8ee; border-radius: 6px;
      padding: 0.8rem 1rem; overflow-x: auto; font-size: 0.85rem; }
code { font-family: 'SF Mono', Menlo, Consolas, monospace;
       background: #f2f4f6; padding: 0.08em 0.3em; border-radius: 3px; }
pre code { background: none; padding: 0; }
table { border-collapse: collapse; margin: 1rem 0; font-size: 0.9rem; }
th, td { border: 1px solid #cfd8e0; padding: 0.35rem 0.7rem; }
th { background: #eef2f5; }
h1, h2, h3 { color: #10314f; }
h2 { border-bottom: 1px solid #e3e8ee; padding-bottom: 0.2rem; }
.api-sig { background: #eef4fa; border-left: 3px solid #4a7fb5;
           padding: 0.4rem 0.8rem; margin-top: 1.6rem;
           font-family: Menlo, monospace; font-size: 0.88rem; }
.api-doc { margin-left: 0.7rem; }
"""

TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8">
<title>{title} — nupgcm</title>
<style>{css}</style></head>
<body><div class="wrap">
<nav><h2>nupgcm</h2>{nav}</nav>
<main>{body}</main>
</div></body></html>
"""


def literate(path):
    """Literate.jl-style transform: top-level comments become prose,
    code becomes fenced blocks; the module docstring leads."""
    src = open(os.path.join(REPO, path)).read()
    m = re.match(r'\s*(?:"""|\'\'\')(.*?)(?:"""|\'\'\')\s*', src, re.S)
    out = []
    if m:
        doc = m.group(1).strip()
        title = doc.splitlines()[0].rstrip(".")
        out.append(f"# {title}\n")
        out.append("\n".join(doc.splitlines()[1:]).strip() + "\n")
        src = src[m.end():]
    out.append(f"\n*Source: [`{path}`](../../{path})*\n")
    code = []

    def flush():
        body = "\n".join(code).strip("\n")
        if body:
            out.append(f"\n```python\n{body}\n```\n")
        code.clear()

    for line in src.splitlines():
        s = line.strip()
        if s.startswith("# ") and not line.startswith(" "):
            flush()
            out.append(s[2:] + "\n")
        else:
            code.append(line)
    flush()
    return "\n".join(out)


def api_markdown():
    """API page from the live package: every exported symbol with its
    signature + docstring, plus the core model/DD method surface."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import nupgcm as npg
    from nupgcm.parallel.dd import DDModel
    from nupgcm.parallel.sharding import make_device_mesh

    out = ["# API reference\n",
           "Public surface of `import nupgcm as npg` (the analog of "
           "the reference's export list, reference src/nuPGCM.jl:90-144), "
           "generated from the live docstrings.\n"]

    def sig_of(obj):
        try:
            return str(inspect.signature(obj))
        except (TypeError, ValueError):
            return ""

    def emit(name, obj, prefix=""):
        doc = inspect.getdoc(obj) or ""
        kind = ("class" if inspect.isclass(obj)
                else "function" if callable(obj) else "module")
        out.append(f'\n<div class="api-sig"><b>{kind}</b> '
                   f'{prefix}{name}{sig_of(obj)}</div>\n')
        if doc:
            out.append(f'<div class="api-doc">\n\n{doc}\n\n</div>\n')

    out.append("\n## Top-level exports\n")
    for name in npg.__all__:
        obj = getattr(npg, name)
        if inspect.ismodule(obj):
            out.append(f"\n- **module** `npg.{name}` — "
                       f"{(inspect.getdoc(obj) or '').splitlines()[0]}\n")
            continue
        emit(name, obj, "npg.")

    out.append("\n## Model methods\n")
    for name in ("rest_state", "set_b", "run", "solve_inversion",
                 "refresh_precond", "retune"):
        if hasattr(npg.PGModel, name):
            emit(name, getattr(npg.PGModel, name), "PGModel.")

    out.append("\n## Distributed runtime (`nupgcm.parallel`)\n")
    emit("make_device_mesh", make_device_mesh)
    emit("DDModel", DDModel)
    for name in ("run", "step", "multi_step", "refresh_precond",
                 "to_dd", "from_dd", "save_checkpoint", "load_checkpoint"):
        emit(name, getattr(DDModel, name), "DDModel.")

    out.append("\n## Mesh generators (`npg.generators`)\n")
    for name in sorted(dir(npg.generators)):
        obj = getattr(npg.generators, name)
        if name.startswith("_") or not inspect.isfunction(obj):
            continue
        if inspect.getmodule(obj) is not npg.generators:
            continue
        emit(name, obj, "generators.")
    return "\n".join(out)


def main():
    os.makedirs(SITE, exist_ok=True)
    rendered = []
    for src, dest, title in PAGES:
        if src == "@api":
            text = api_markdown()
        elif src.startswith("@literate:"):
            text = literate(src.split(":", 1)[1])
        else:
            text = open(os.path.join(HERE, src)).read()
        rendered.append((dest, title, text))

    for dest, title, text in rendered:
        nav = "".join(
            f'<a href="{d}"{" class=current" if d == dest else ""}>{t}</a>'
            for d, t, _ in rendered)
        body = markdown.markdown(
            text, extensions=["fenced_code", "tables", "toc", "md_in_html"])
        html = TEMPLATE.format(title=title, css=CSS, nav=nav, body=body)
        with open(os.path.join(SITE, dest), "w") as f:
            f.write(html)
        print(f"wrote docs/site/{dest} ({len(html)} bytes)")


if __name__ == "__main__":
    main()

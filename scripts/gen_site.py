"""Render docs/*.md into a static HTML site at docs/site/.

The reference ships a built Sphinx site (/root/reference/docs/*.html); this
is the gigalens_tpu equivalent, built with python-markdown + pygments (the
only doc tooling baked into the image — no sphinx/mkdocs). One self-contained
page per markdown doc, shared sidebar navigation, pygments-highlighted code,
and a landing page generated from README.md.

Usage: python scripts/gen_site.py        # writes docs/site/*.html
"""
import os
import re
import sys

import markdown
from pygments.formatters import HtmlFormatter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(ROOT, "docs")
OUT = os.path.join(DOCS, "site")

# (source file, nav title); order defines the sidebar
PAGES = [
    ("README.md", "gigalens_tpu"),
    ("docs/quickstart.md", "Quickstart"),
    ("docs/overview.md", "Architecture overview"),
    ("docs/model-spec.md", "Model specification"),
    ("docs/simulation.md", "Simulation"),
    ("docs/profiles.md", "Profiles"),
    ("docs/modelling.md", "Modelling (MAP/SVI/HMC/SMC)"),
    ("docs/inversion.md", "Pixelated sources"),
    ("docs/multiplane.md", "Multi-plane lensing"),
    ("docs/pointsource.md", "Point sources & time delays"),
    ("docs/survey.md", "Survey / catalogue mode"),
    ("docs/scaling.md", "Scaling & sharding"),
    ("docs/kernels.md", "Kernels"),
    ("docs/migration.md", "Migrating from GIGA-Lens"),
    ("docs/api.md", "API reference"),
]

CSS = """
:root {
  --bg: #ffffff; --fg: #1a1f24; --muted: #5b6770; --accent: #0b6aa8;
  --side-bg: #f4f6f8; --border: #dde3e8; --code-bg: #f6f8fa;
}
* { box-sizing: border-box; }
body { margin: 0; font: 16px/1.6 -apple-system, "Segoe UI", Roboto, Helvetica,
       Arial, sans-serif; color: var(--fg); background: var(--bg); }
a { color: var(--accent); text-decoration: none; }
a:hover { text-decoration: underline; }
.layout { display: flex; min-height: 100vh; }
nav.side { width: 260px; flex-shrink: 0; background: var(--side-bg);
  border-right: 1px solid var(--border); padding: 1.2rem 0.8rem;
  position: sticky; top: 0; height: 100vh; overflow-y: auto; }
nav.side .brand { font-weight: 700; font-size: 1.15rem; margin: 0 0.5rem 1rem;
  display: block; color: var(--fg); }
nav.side a.item { display: block; padding: 0.28rem 0.6rem; border-radius: 6px;
  color: var(--muted); font-size: 0.93rem; }
nav.side a.item:hover { background: #e8edf1; text-decoration: none; }
nav.side a.item.active { background: var(--accent); color: #fff; }
main { flex: 1; min-width: 0; padding: 2rem 3rem 4rem; max-width: 60rem; }
main h1, main h2, main h3 { line-height: 1.25; scroll-margin-top: 1rem; }
main h1 { border-bottom: 1px solid var(--border); padding-bottom: 0.4rem; }
main h2 { border-bottom: 1px solid var(--border); padding-bottom: 0.25rem;
  margin-top: 2.2rem; }
pre { background: var(--code-bg); border: 1px solid var(--border);
  border-radius: 8px; padding: 0.9rem 1.1rem; overflow-x: auto;
  font-size: 0.88rem; line-height: 1.45; }
code { font-family: ui-monospace, SFMono-Regular, Menlo, Consolas, monospace;
  font-size: 0.92em; }
:not(pre) > code { background: var(--code-bg); border: 1px solid var(--border);
  border-radius: 4px; padding: 0.08em 0.35em; }
table { border-collapse: collapse; margin: 1rem 0; display: block;
  overflow-x: auto; max-width: 100%; }
th, td { border: 1px solid var(--border); padding: 0.35rem 0.7rem;
  font-size: 0.92rem; text-align: left; }
th { background: var(--side-bg); }
blockquote { margin: 1rem 0; padding: 0.2rem 1rem; border-left: 4px solid
  var(--accent); background: var(--side-bg); border-radius: 0 6px 6px 0; }
footer { color: var(--muted); font-size: 0.85rem; margin-top: 3rem;
  border-top: 1px solid var(--border); padding-top: 1rem; }
@media (max-width: 820px) {
  .layout { flex-direction: column; }
  nav.side { width: 100%; height: auto; position: static; }
  main { padding: 1.2rem; }
}
"""

TEMPLATE = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{title} — gigalens_tpu</title>
<style>{css}
{pygments}</style>
</head>
<body>
<div class="layout">
<nav class="side">
<a class="brand" href="index.html">gigalens_tpu</a>
{nav}
</nav>
<main>
{body}
<footer>gigalens_tpu — a JAX/XLA re-design of GIGA-Lens
(gigalens.github.io). Generated by scripts/gen_site.py.</footer>
</main>
</div>
</body>
</html>
"""


def out_name(src):
    base = os.path.basename(src)
    if base == "README.md":
        return "index.html"
    return os.path.splitext(base)[0] + ".html"


def fix_links(html):
    """Rewrite intra-repo markdown links to the rendered pages."""
    def sub(m):
        href = m.group(1)
        target = href.split("#")[0]
        frag = href[len(target):]
        base = os.path.basename(target)
        if base.endswith(".md"):
            return 'href="%s%s"' % (out_name(base), frag)
        return m.group(0)

    return re.sub(r'href="([^"]+\.md(?:#[^"]*)?)"', sub, html)


def main():
    os.makedirs(OUT, exist_ok=True)
    pyg = HtmlFormatter(style="default").get_style_defs(".codehilite")
    md = markdown.Markdown(
        extensions=["fenced_code", "tables", "toc", "codehilite", "admonition"],
        extension_configs={"codehilite": {"guess_lang": False}},
    )

    nav_entries = []
    for src, title in PAGES:
        nav_entries.append((out_name(src), title))

    written = 0
    for src, title in PAGES:
        path = os.path.join(ROOT, src)
        if not os.path.exists(path):
            print(f"skip missing {src}", file=sys.stderr)
            continue
        with open(path) as f:
            text = f.read()
        md.reset()
        body = fix_links(md.convert(text))
        page = out_name(src)
        nav = "\n".join(
            '<a class="item%s" href="%s">%s</a>'
            % (" active" if fn == page else "", fn, t)
            for fn, t in nav_entries
        )
        html = TEMPLATE.format(
            title=title, css=CSS, pygments=pyg, nav=nav, body=body
        )
        with open(os.path.join(OUT, page), "w") as f:
            f.write(html)
        written += 1
    print(f"wrote {written} pages to {OUT}")


if __name__ == "__main__":
    main()

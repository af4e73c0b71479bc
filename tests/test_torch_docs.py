"""The port's docs pages (``docs/torch/*.md``) cite only names that exist:
every ``cvmatrix_tpu_torch.…`` dotted name resolves to a module or an
attribute, and every page the index links is there."""

import importlib
import pathlib
import re

import pytest

DOCS = pathlib.Path(__file__).resolve().parents[1] / "docs" / "torch"
NAME = re.compile(r"\bcvmatrix_tpu_torch(?:\.[A-Za-z_][A-Za-z0-9_]*)+")
PAGES = ("index", "quickstart", "api", "precision", "scaling", "benchmarks")


def resolve(dotted: str):
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ModuleNotFoundError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(dotted)


def test_every_page_is_there():
    assert {p.stem for p in DOCS.glob("*.md")} == set(PAGES)
    index = (DOCS / "index.md").read_text()
    for page in PAGES[1:]:
        assert f"({page}.md)" in index


@pytest.mark.parametrize("page", PAGES)
def test_cited_names_resolve(page):
    names = sorted(set(NAME.findall((DOCS / f"{page}.md").read_text())))
    for dotted in names:
        assert resolve(dotted) is not None, dotted
    if page in ("api", "quickstart", "scaling"):
        assert len(names) >= 10, names

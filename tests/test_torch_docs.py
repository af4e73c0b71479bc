"""The port's docs pages (``docs/torch/*.md``) cite only names that exist:
every ``cvmatrix_tpu_torch.…`` dotted name resolves to a module or an
attribute, or is the name of a span the port opens, and every page the
index links is there; the API page lists every span."""

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


def span_names():
    """The spans the port opens (``utils/profiling.py``), each route and
    sweep entry by name, and the stems ``…route`` (of ``core.batch`` and
    of ``models.pls``) and ``…sweep`` that the docs write before
    ``.<route>`` and ``.<entry>``."""
    from cvmatrix_tpu_torch.core.batch import TPU_KERNELS
    from cvmatrix_tpu_torch.utils import profiling as P

    return ({P.FIT, P.SOURCES, P.STATS, P.H2D, P.REDUCE_FN,
             P.ROUTE[:-1], P.SWEEP[:-1], P.PLS_ROUTE[:-1]}
            | {P.ROUTE + r for r in TPU_KERNELS}
            | {P.SWEEP + e for e in ("cross_validate_reduce",
                                     "materialize_sweep")})


def test_every_page_is_there():
    assert {p.stem for p in DOCS.glob("*.md")} == set(PAGES)
    index = (DOCS / "index.md").read_text()
    for page in PAGES[1:]:
        assert f"({page}.md)" in index


@pytest.mark.parametrize("page", PAGES)
def test_cited_names_resolve(page):
    names = sorted(set(NAME.findall((DOCS / f"{page}.md").read_text())))
    spans = span_names()
    for dotted in names:
        assert dotted in spans or resolve(dotted) is not None, dotted
    if page in ("api", "quickstart", "scaling"):
        assert len(names) >= 10, names


def test_api_lists_every_span():
    from cvmatrix_tpu_torch.utils import profiling as P

    text = (DOCS / "api.md").read_text()
    for name in (P.FIT, P.SOURCES, P.STATS, P.H2D, P.REDUCE_FN,
                 P.ROUTE + "<route>", P.SWEEP + "<entry>"):
        assert f"`{name}`" in text, name

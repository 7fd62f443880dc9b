"""``tcgan_torch.utils.cli_docs`` against ``tcgan_tpu.utils.cli_docs``: the
port's page lists a counterpart of every reference entry point, and
``docs/cli_reference_torch.md`` is what the live parsers print (the
freshness fence of ``tests/test_cli.py``)."""

from pathlib import Path

from tcgan_tpu.utils import cli_docs as jdocs
from tcgan_torch.utils import cli_docs as tdocs


def test_every_reference_entry_point_has_a_counterpart():
    want = [(m.replace("tcgan_tpu.", "tcgan_torch.", 1), blurb)
            for m, blurb in jdocs.ENTRY_POINTS]
    assert list(tdocs.ENTRY_POINTS) == want
    assert len(want) == 16


def test_cli_reference_torch_docs_fresh(tmp_path):
    """docs/cli_reference_torch.md is generated from the port's parsers; a
    flag change without `make docs-torch` fails here."""
    path = Path(__file__).resolve().parents[1] / "docs" / \
        "cli_reference_torch.md"
    text = tdocs.render()
    assert path.read_text() == text, (
        "docs/cli_reference_torch.md is stale — run `make docs-torch`")
    out = tmp_path / "ref.md"
    assert tdocs.main(["-o", str(out)]) == 0
    assert out.read_text() == text
    # the page documents the reference's backend names beside the port's
    assert "--solver-backend {torch,cuda,xla,pallas}" in text
    assert "## `tcgan_tpu" not in text and "python -m tcgan_tpu" not in text

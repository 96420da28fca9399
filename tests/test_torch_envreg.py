"""The port's knob registry against the JAX package's, on the CPU.

The same raw strings through both registries' typed accessors give the
same values and the same errors (the reference's accessor cases and its
bool parse table); every knob the port registers has the reference's type
and default; the names the port leaves out are exactly the eighteen
reference-only ones; ``config.py`` is a view over the registry; and
``envdoc`` lists each knob once.
"""

import os
import re

import pytest

from vescale_tpu.analysis import envreg as ref_envreg

from vescale_tpu_torch import config
from vescale_tpu_torch.analysis import envreg
from vescale_tpu_torch.analysis.__main__ import main as cli_main

PORT_NAMES = [v.name for v in envreg.all_vars()]


@pytest.mark.parametrize("raw,expected", [
    ("", False), ("0", False), ("false", False), ("OFF", False), ("no", False),
    (" No ", False), ("FALSE", False), ("1", True), ("true", True), ("2", True), ("yes", True),
    ("on", True), ("anything", True),
])
def test_bool_parse_table_is_the_references(monkeypatch, raw, expected):
    monkeypatch.setenv("VESCALE_STRICT_REDISTRIBUTE", raw)
    assert envreg.get_bool("VESCALE_STRICT_REDISTRIBUTE") is expected
    assert ref_envreg.get_bool("VESCALE_STRICT_REDISTRIBUTE") is expected
    assert config.get_bool("VESCALE_STRICT_REDISTRIBUTE") is expected
    assert envreg.coerce_bool(raw, not expected) is ref_envreg.coerce_bool(raw, not expected)
    assert envreg._FALSE == ref_envreg._FALSE


def test_typed_accessors_are_live_and_loud_as_the_references(monkeypatch):
    for reg in (ref_envreg, envreg):
        monkeypatch.delenv("VESCALE_REDISTRIBUTE_MAX_HOPS", raising=False)
        assert reg.get_int("VESCALE_REDISTRIBUTE_MAX_HOPS") == 3
        monkeypatch.setenv("VESCALE_REDISTRIBUTE_MAX_HOPS", "5")
        assert reg.get_int("VESCALE_REDISTRIBUTE_MAX_HOPS") == 5
        monkeypatch.setenv("VESCALE_REDISTRIBUTE_MAX_HOPS", "junk")
        with pytest.raises(ValueError, match="VESCALE_REDISTRIBUTE_MAX_HOPS"):
            reg.get_int("VESCALE_REDISTRIBUTE_MAX_HOPS")
        monkeypatch.setenv("VESCALE_BARRIER_TIMEOUT", "5s")
        with pytest.raises(ValueError, match="expected a float"):
            reg.get_float("VESCALE_BARRIER_TIMEOUT")
        monkeypatch.delenv("VESCALE_BARRIER_TIMEOUT")
        assert reg.get_float("VESCALE_BARRIER_TIMEOUT") is None


def test_none_defaults_unregistered_and_conflicts_as_the_references(monkeypatch):
    monkeypatch.delenv("VESCALE_BARRIER_TIMEOUT", raising=False)
    assert envreg.get_float("VESCALE_BARRIER_TIMEOUT") is None
    assert envreg.get_int("VESCALE_SERVE_OPS_PORT") is None
    for reg in (ref_envreg, envreg):
        with pytest.raises(KeyError, match="not registered"):
            reg.get_raw("VESCALE_" + "NOT_A_REAL_KNOB")
        with pytest.raises(ValueError, match="conflicting"):
            reg.register("VESCALE_STRICT_REDISTRIBUTE", "int", 7, "clash")
        prev = reg.lookup("VESCALE_STRICT_REDISTRIBUTE")
        assert reg.register(prev.name, prev.type, prev.default, prev.doc) == prev
    with pytest.raises(ValueError, match="VESCALE_"):
        envreg.EnvVar("NOT_VESCALE", "int", 0, "x")
    with pytest.raises(ValueError, match="unsupported type"):
        envreg.EnvVar("VESCALE_" + "X", "list", 0, "x")


# every knob, each raw string: both registries' typed accessor agrees
_RAWS = (None, "", "0", "1", "7", "-3", "2.5", "off", "yes", "5s", " 4 ")


def _read(reg, name, monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, raw)
    get = getattr(reg, "get_" + reg.lookup(name).type)
    try:
        return ("ok", get(name), reg.get_raw(name))
    except ValueError as e:
        return ("error", type(e).__name__, re.sub(r"\(see .*\)", "", str(e)).strip())


@pytest.mark.parametrize("name", PORT_NAMES)
def test_every_knob_reads_as_the_references(monkeypatch, name):
    ref = ref_envreg.lookup(name)
    mine = envreg.lookup(name)
    assert (mine.type, mine.default) == (ref.type, ref.default)
    assert type(mine.default) is type(ref.default)
    for raw in _RAWS:
        assert _read(envreg, name, monkeypatch, raw) == _read(ref_envreg, name, monkeypatch, raw), raw


def test_the_port_leaves_out_exactly_the_reference_only_knobs():
    ref_names = {v.name for v in ref_envreg.all_vars()}
    assert set(PORT_NAMES) <= ref_names
    assert ref_names - set(PORT_NAMES) == set(envreg.REFERENCE_ONLY)
    assert len(envreg.REFERENCE_ONLY) == 18 and len(PORT_NAMES) == 89


def test_docs_say_nothing_false_of_the_port():
    """A doc the port keeps is the reference's, but for what is not true of
    the port: no TPU, XLA, JAX or compile step."""
    for v in envreg.all_vars():
        assert not re.search(r"\bTPU|XLA|\bjax|\bjit\b|recompil|compile-time|AOT", v.doc), v.name
        assert v.doc.endswith(".") and "\n" not in v.doc, v.name


def test_config_is_a_view_over_the_registry(monkeypatch):
    assert config.DEFAULTS == {v.name: v.default for v in envreg.all_vars()}
    with pytest.raises(KeyError):
        config.get_int("VESCALE_KERNELS")
    with pytest.raises(KeyError):
        config.get_bool("VESCALE_" + "NOT_A_REAL_KNOB")
    monkeypatch.setenv("VESCALE_SERVE_SLOTS", "5")
    monkeypatch.setenv("VESCALE_COSTAUDIT_DECAY", "0.5")
    monkeypatch.setenv("VESCALE_FLEET_JOURNAL_FSYNC", "always")
    assert config.get_int("VESCALE_SERVE_SLOTS") == envreg.get_int("VESCALE_SERVE_SLOTS") == 5
    assert config.get_float("VESCALE_COSTAUDIT_DECAY") == envreg.get_float(
        "VESCALE_COSTAUDIT_DECAY") == 0.5
    assert config.get_str("VESCALE_FLEET_JOURNAL_FSYNC") == "always"
    # config's own rule, kept: a string knob set empty reads as unset
    monkeypatch.setenv("VESCALE_FLEET_JOURNAL_FSYNC", "")
    assert config.get_str("VESCALE_FLEET_JOURNAL_FSYNC") == "flush"
    assert envreg.get_str("VESCALE_FLEET_JOURNAL_FSYNC") == ""


def test_envdoc_lists_every_knob_once(tmp_path, capsys):
    table = envreg.markdown_table().splitlines()
    rows = [ln for ln in table if ln.startswith("| `VESCALE_")]
    names = [ln.split("`")[1] for ln in rows]
    assert names == sorted(PORT_NAMES) and len(set(names)) == len(names) == 89
    ref_rows = {ln.split("`")[1]: ln.split(" | ")[1:3]
                for ln in ref_envreg.markdown_table().splitlines() if ln.startswith("| `VESCALE_")}
    for ln, name in zip(rows, names):
        assert ln.split(" | ")[1:3] == ref_rows[name], name  # type and default columns

    before = set(os.listdir(tmp_path))
    assert cli_main(["envdoc"]) == 0
    printed = capsys.readouterr().out
    assert printed == envreg.configuration_markdown() + "\n"
    assert set(os.listdir(tmp_path)) == before
    for name in PORT_NAMES:
        assert printed.count(f"| `{name}` |") == 1, name
    out = tmp_path / "configuration.md"
    assert cli_main(["envdoc", "--write", str(out)]) == 0
    assert out.read_text() == envreg.configuration_markdown()
    assert f"wrote {out}" in capsys.readouterr().out

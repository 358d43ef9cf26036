"""The port's config tree (``utils/config.py``) against the JAX package's:
every section's fields and defaults, every env var the reference's
``load_config`` reads moving the same field in both, the JSON file and the
overrides applied in the same order, and an unknown key refused with
``KeyError`` in both (after tests/test_config.py)."""

import ast
import dataclasses
import inspect
import json

import pytest

pytest.importorskip("torch")

import finchat_tpu.utils.config as jcfg  # noqa: E402
import finchat_tpu_torch.utils.config as tcfg  # noqa: E402

SECTIONS = [f.name for f in dataclasses.fields(jcfg.AppConfig)]


def _env_wiring() -> list[tuple[str, str, str, str]]:
    """(env var, reader, section, field) of every ``cfg.<s>.<f> =
    _env*("NAME", ...)`` assignment in the reference's ``load_config``."""
    tree = ast.parse(inspect.getsource(jcfg.load_config))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and isinstance(node.value.func, ast.Name) \
                and node.value.func.id.startswith("_env"):
            target = ast.unparse(node.targets[0]).split(".")
            out.append((node.value.args[0].value, node.value.func.id, target[1], target[2]))
    return out


ENV = _env_wiring()


def _clear_env(monkeypatch):
    for name, *_ in ENV:
        monkeypatch.delenv(name, raising=False)


def test_constants_equal():
    for name in ("USER_MESSAGE_TOPIC", "AI_RESPONSE_TOPIC", "TRANSACTION_UPSERT_TOPIC",
                 "GROUP_ID", "CONTEXT_COLLECTION_NAME", "MESSAGE_COLLECTION_NAME",
                 "TRANSACTION_COLLECTION_NAME"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name


@pytest.mark.parametrize("section", SECTIONS)
def test_section_fields_and_defaults_equal(section, monkeypatch):
    _clear_env(monkeypatch)
    want = getattr(jcfg.AppConfig(), section)
    got = getattr(tcfg.AppConfig(), section)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # and as load_config builds them from an empty environment
    assert dataclasses.asdict(getattr(tcfg.load_config(), section)) == \
        dataclasses.asdict(getattr(jcfg.load_config(), section))


def test_the_wiring_walk_sees_every_reader():
    assert len(ENV) >= 90
    assert ("KAFKA_SERVER", "_env", "kafka", "bootstrap_servers") in ENV
    assert ("FINCHAT_WARMUP", "_env_bool", "engine", "warmup_on_start") in ENV


def _value(reader: str, current):
    """An env value that moves a field off its default."""
    if reader == "_env_bool":
        return "0" if current else "1"
    if reader == "_env_int":
        return str(int(current) + 7)
    if reader == "_env_float":
        return str(float(current) + 2.5)
    return f"{current}-set"


@pytest.mark.parametrize("name,reader,section,key", ENV, ids=[e[0] for e in ENV])
def test_env_var_moves_the_same_field(name, reader, section, key, monkeypatch):
    _clear_env(monkeypatch)
    default = getattr(getattr(jcfg.load_config(), section), key)
    monkeypatch.setenv(name, _value(reader, default))
    want, got = jcfg.load_config(), tcfg.load_config()
    assert getattr(getattr(want, section), key) != default
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_reference_env_names_and_librdkafka_switch(monkeypatch):
    _clear_env(monkeypatch)
    for pkg in (jcfg, tcfg):
        assert pkg.load_config().kafka.librdkafka_config() == {
            "bootstrap.servers": "", "security.protocol": "PLAINTEXT"}
    monkeypatch.setenv("KAFKA_SERVER", "broker:9092")
    monkeypatch.setenv("KAFKA_USERNAME", "u")
    monkeypatch.setenv("KAFKA_PASSWORD", "p")
    got = tcfg.load_config().kafka.librdkafka_config()
    assert got == jcfg.load_config().kafka.librdkafka_config()
    assert got["security.protocol"] == "SASL_SSL"


def test_file_then_overrides_order(tmp_path, monkeypatch):
    """defaults <- env <- JSON file <- overrides, nested dicts and dotted
    keys alike; the offsets dir defaults to the journal dir after all of
    them."""
    _clear_env(monkeypatch)
    monkeypatch.setenv("FINCHAT_MAX_SEQS", "3")
    monkeypatch.setenv("FINCHAT_PAGE_SIZE", "64")
    monkeypatch.setenv("FINCHAT_NUM_PAGES", "99")
    cfile = tmp_path / "cfg.json"
    cfile.write_text(json.dumps({"engine.max_seqs": 8, "engine": {"page_size": 32},
                                 "model": {"preset": "llama3-8b"},
                                 "journal.path": str(tmp_path / "j")}))
    over = {"engine.max_seqs": 16, "serve": {"port": 9}}
    want = jcfg.load_config(str(cfile), overrides=dict(over))
    got = tcfg.load_config(str(cfile), overrides=dict(over))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.engine.max_seqs, got.engine.page_size, got.engine.num_pages) == (16, 32, 99)
    assert got.model.preset == "llama3-8b" and got.serve.port == 9
    assert got.kafka.offsets_dir == str(tmp_path / "j")


@pytest.mark.parametrize("where", ["override", "file", "nested"])
def test_unknown_key_raises_keyerror_in_both(where, tmp_path):
    bad = {"override": {"engine.max_seq": 4}, "file": {"nope.x": 1},
           "nested": {"engine": {"max_seq": 4}}}[where]
    for pkg in (jcfg, tcfg):
        if where == "file":
            cfile = tmp_path / "cfg.json"
            cfile.write_text(json.dumps(bad))
            with pytest.raises(KeyError):
                pkg.load_config(str(cfile))
        else:
            with pytest.raises(KeyError):
                pkg.load_config(overrides=dict(bad))


def test_compilation_cache_dir_is_documented_inert():
    src = inspect.getsource(tcfg)
    assert "compilation_cache_dir" in src and "inert" in src

"""The port's compose importer (runtime/compose.py) against the JAX one,
with and without PyYAML.

The cases of tests/test_compose.py on both packages (the same Topology,
the same errors), the port's network computing from it on the CPU, then
its wiring: `python -m misaka_tpu_torch check|disasm <file.yml>`,
MISAKA_TOPOLOGY=<file.yml> at boot and the registry's `compose` uploads.
A host without PyYAML (hidden here through sys.modules) refuses with the
CLI's and the app's status 2 and the registry's 400, and everything else
still runs.
"""

import json
import os
import sys
import textwrap
import threading
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

from misaka_tpu.runtime import compose as jcompose
from misaka_tpu_torch.runtime import compose as tcompose
from tests.test_compose import SAMPLE

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPLOY = os.path.join(ROOT, "deploy", "docker-compose.yml")


@pytest.fixture
def no_yaml(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)


def both(text):
    return tcompose.parse_compose(text), jcompose.parse_compose(text)


def same(t, j):
    assert (t.node_info, t.programs, t.stack_cap, t.in_cap, t.out_cap) == \
        (j.node_info, j.programs, j.stack_cap, j.in_cap, j.out_cap)


def test_parse_sample_end_to_end():
    t, j = both(SAMPLE)
    same(t, j)
    assert t.node_info == {"alpha": "program", "beta": "program", "store": "stack"}
    assert t.programs["alpha"].endswith("OUT ACC\n")  # one NOP slot, parity
    net = t.compile(device="cpu")
    state, outs = net.compute_stream(net.init_state(), [10, 20])
    assert outs == [12, 22]


@pytest.mark.parametrize("case", ["list_env", "no_master", "caps"])
def test_variants_equal_jax(case):
    if case == "list_env":
        text = SAMPLE.replace("environment:\n      NODE_TYPE: stack",
                              'environment:\n      - "NODE_TYPE=stack"')
        t, j = both(text)
        assert t.node_info["store"] == "stack"
    elif case == "no_master":
        text = textwrap.dedent("""\
            services:
              solo:
                environment:
                  NODE_TYPE: program
                  PROGRAM: |
                    IN ACC
                    OUT ACC
              store:
                environment:
                  NODE_TYPE: stack
            """)
        t, j = both(text)
        assert t.node_info == {"solo": "program", "store": "stack"}
    else:
        t = tcompose.parse_compose(SAMPLE, stack_cap=4, in_cap=8, out_cap=16)
        j = jcompose.parse_compose(SAMPLE, stack_cap=4, in_cap=8, out_cap=16)
    same(t, j)


@pytest.mark.parametrize("text,match", [
    (SAMPLE.replace('"store": {"type": "stack"}', '"ghost": {"type": "stack"}'), "disagrees"),
    (textwrap.dedent("""\
        services:
          gateway:
            environment:
              NODE_TYPE: master
              NODE_INFO: '["alpha", "beta"]'
          alpha:
            environment:
              NODE_TYPE: program
        """), "NODE_INFO is not valid"),
    (":\n  - {", "invalid YAML"),
    ("services: 3", "no services"),
    ("services:\n  a:\n    image: x\n", "NODE_TYPE"),
], ids=["mismatch", "node_info_list", "bad_yaml", "no_services", "no_node_type"])
def test_errors_equal_jax(text, match):
    with pytest.raises(tcompose.ComposeError, match=match) as got:
        tcompose.parse_compose(text)
    with pytest.raises(jcompose.ComposeError) as want:
        jcompose.parse_compose(text)
    assert str(got.value) == str(want.value)


def test_bad_program_surfaces_at_compile():
    with pytest.raises(Exception, match="not a valid instruction"):
        tcompose.parse_compose(SAMPLE.replace("IN ACC", "FROB 99")).compile(device="cpu")


def test_deploy_file_computes_like_jax():
    t, j = tcompose.load_compose(DEPLOY), jcompose.load_compose(DEPLOY)
    same(t, j)
    net = t.compile(device="cpu")
    _, outs = net.compute_stream(net.init_state(), [5])
    assert outs == [7]


def test_without_pyyaml_parse_raises_importerror(no_yaml):
    with pytest.raises(ImportError):
        tcompose.parse_compose(SAMPLE)
    # everything else still runs: the JSON topology path
    from misaka_tpu_torch import networks

    net = networks.add2().compile(device="cpu")
    assert net.compute_stream(net.init_state(), [1])[1] == [3]


@pytest.mark.parametrize("cmd", ["check", "disasm"])
def test_cli_reads_compose_like_jax(cmd, capsys):
    from misaka_tpu.__main__ import main as jcli
    from misaka_tpu_torch.__main__ import main as tcli

    outs = []
    for cli in (tcli, jcli):
        assert cli([cmd, DEPLOY]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]


@pytest.mark.parametrize("cmd", ["check", "disasm"])
def test_cli_without_pyyaml_exits_2(cmd, capsys, no_yaml):
    from misaka_tpu_torch.__main__ import main as tcli

    assert tcli([cmd, DEPLOY]) == 2
    assert "PyYAML" in capsys.readouterr().err


def test_app_boots_compose_topology(monkeypatch):
    from misaka_tpu_torch.runtime import app

    m = app.build_master_from_env({"MISAKA_TOPOLOGY": DEPLOY, "MISAKA_DEVICE": "cpu",
                                   "MISAKA_STACK_CAP": "16"})
    m.run()
    try:
        assert m.compute(5) == 7 and m.status()["stack_cap"] == 16
    finally:
        m.close()


def _post(base, path, fields):
    req = urllib.request.Request(base + path, data=urllib.parse.urlencode(fields).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("yaml_present", [True, False], ids=["pyyaml", "no_pyyaml"])
def test_registry_compose_upload(tmp_path, monkeypatch, yaml_present):
    """POST /programs compose=<yaml>: served like the JAX registry's with
    PyYAML, a 400 without it."""
    from misaka_tpu.runtime.master import MasterNode as JMaster
    from misaka_tpu.runtime.master import make_http_server as j_http
    from misaka_tpu.runtime.registry import ProgramRegistry as JRegistry
    from misaka_tpu_torch import networks as tnet
    from misaka_tpu.networks import add2 as jadd2
    from misaka_tpu_torch.runtime.master import MasterNode as TMaster
    from misaka_tpu_torch.runtime.master import make_http_server as t_http
    from misaka_tpu_torch.runtime.registry import ProgramRegistry as TRegistry

    for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG", "MISAKA_CANARY"):
        monkeypatch.setenv(switch, "0")
    with open(DEPLOY) as f:
        text = f.read()
    results = []
    for pkg in ("torch", "jax"):
        if pkg == "torch":
            m = TMaster(tnet.add2(), batch=2, device="cpu", engine="scan")
            reg = TRegistry(str(tmp_path / pkg), batch=2, engine="scan", device="cpu")
            mk = t_http
        else:
            m = JMaster(jadd2(), batch=2, engine="scan")
            reg = JRegistry(str(tmp_path / pkg), batch=2, engine="scan")
            mk = j_http
        reg.seed("default", m)
        httpd = mk(m, port=0, registry=reg)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            with monkeypatch.context() as mp:
                if not yaml_present:
                    mp.setitem(sys.modules, "yaml", None)
                st, body = _post(base, "/programs", {"name": "dep", "compose": text})
            if not yaml_present:
                assert st == 400 and b"PyYAML" in body
                return
            assert st == 200, body
            st, out = _post(base, "/programs/dep/compute", {"value": "5"})
            results.append((json.loads(body)["name"], st, json.loads(out)))
        finally:
            httpd.shutdown()
            httpd.server_close()
            reg.close()
            m.close()
    assert results[0] == results[1] == ("dep", 200, {"value": 7})

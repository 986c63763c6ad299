"""repro_torch.analysis: each rule's firing and clean cases in the port's
own idiom (mirroring tests/test_analysis.py), noqa suppression, the
baseline workflow, the CLI self-test without jax, the repo-clean
invariant (``python -m repro_torch.analysis`` clean with
``analysis_baseline_torch.json``), RA002's dynamic twin (the port's
configs and plans are frozen and hash), and parity with the JAX
package's linter on the shared infrastructure and RA005.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import core as ref_core
from repro.analysis import rules as ref_rules
from repro_torch.analysis import rules
from repro_torch.analysis.__main__ import BASELINE, FIXTURE, default_paths
from repro_torch.analysis.core import (DEFAULT_EXCLUDES, Finding,
                                       SourceFile, apply_baseline,
                                       collect_files, load_baseline,
                                       run_analysis, run_rules,
                                       save_baseline)
from repro_torch.analysis.rules import RULE_DOCS

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
REF_FIXTURE = (REPO / "src" / "repro" / "analysis" / "_fixtures"
               / "known_bad.py")


def _analyze(src: str, name: str = "mod.py"):
    f = SourceFile(Path(name), name, textwrap.dedent(src))
    return run_rules([f])


def _codes(findings):
    return [f.rule for f in findings]


def _mutated(rel: str, old: str, new: str):
    """The findings on a port file with one edit applied."""
    text = (REPO / rel).read_text()
    assert text.count(old) == 1, (rel, old)
    f = SourceFile(REPO / rel, rel, text.replace(old, new))
    return run_rules([f])


class TestRuleFiring:
    def test_all_rules_fire_on_fixture(self):
        files = collect_files([FIXTURE], root=FIXTURE.parent, excludes=())
        assert {f.rule for f in run_rules(files)} == set(RULE_DOCS)

    def test_fixture_excluded_from_normal_runs(self):
        files = collect_files([FIXTURE.parent.parent], root=REPO)
        assert files and all("_fixtures" not in f.rel for f in files)
        assert "_fixtures" in DEFAULT_EXCLUDES

    # ---- RA001 ----------------------------------------------------------
    @pytest.mark.parametrize("before", [
        "state.params['embed'].clone()",
        "copy_tree(state.params, dev)",
        "plan.device_put_params(cfg, state.params, copy=True)",
    ])
    def test_ra001_copy_before_update_is_clean(self, before):
        findings = _analyze(f"""
            from repro_torch.training import train_step

            def run(cfg, rl, tc, state, batch, plan, dev):
                old = {before}
                state, m = train_step(cfg, rl, tc, state, batch)
                return state, old
        """)
        assert "RA001" not in _codes(findings)

    @pytest.mark.parametrize("before,call", [
        ("state.params['embed']", "train_step(cfg, rl, tc, state, batch)"),
        ("tree_leaves(state.params)", "sft_step(cfg, tc, state, x, y)"),
        ("state.opt.m", "adamw_update(tc, g, state.opt, state.params, lr)"),
        ("state.params['embed'].detach()", "step_fn(state, batch)"),
        ("cache['ssm']", "mamba_block(cfg, p, x, cache, True)"),
    ])
    def test_ra001_alias_read_after_update_fires(self, before, call):
        findings = _analyze(f"""
            def run(cfg, rl, tc, state, batch, g, lr, x, y, p, cache):
                old = {before}
                out = {call}
                return out, old
        """)
        assert _codes(findings) == ["RA001"]
        assert "updates in place" in findings[0].message

    def test_ra001_step_built_by_factory_fires(self):
        findings = _analyze("""
            from repro_torch.parallel import make_sharded_train_step

            def run(cfg, rl, tc, plan, state, batch):
                update = make_sharded_train_step(cfg, rl, tc, plan)
                snap = state.params
                state, m = update(state, batch)
                return snap
        """)
        assert _codes(findings) == ["RA001"]

    def test_ra001_read_in_a_branch_that_returned_is_clean(self):
        # parallel/step.py's shape: the adamw arm returns before the read
        findings = _analyze("""
            def upd(tc, grads, state, lr, adamw):
                shards = tree_leaves(state.params)
                if adamw:
                    _, opt = adamw_update(tc, grads, state.opt,
                                          state.params, lr)
                    return opt
                return shards
        """)
        assert findings == []

    def test_ra001_learner_node_borrowing_the_callers_state_fires(self):
        # the PR 17 bug class, on the port's own LearnerNode
        findings = _mutated(
            "src/repro_torch/hetero/nodes.py",
            'self.state = self.plan.device_put_state(cfg, state, "adamw",\n'
            '                                                copy=True)',
            "self.state = state")
        assert _codes(findings) == ["RA001"]
        assert "LearnerNode" in findings[0].message

    def test_ra001_sampler_node_borrowing_params_fires(self):
        findings = _mutated(
            "src/repro_torch/hetero/nodes.py",
            "self.params = self.plan.device_put_params(cfg, params, "
            "copy=True)", "self.params = params")
        assert _codes(findings) == ["RA001"]
        assert "SamplerNode" in findings[0].message

    # ---- RA002 ----------------------------------------------------------
    def test_ra002_frozen_dataclass_key_is_clean(self):
        findings = _analyze("""
            import dataclasses, functools

            @dataclasses.dataclass(frozen=True)
            class Cfg:
                n: int = 1

            @functools.lru_cache(maxsize=8)
            def build_for(cfg: Cfg):
                return cfg.n
        """)
        assert findings == []

    @pytest.mark.parametrize("body,needle", [
        ("@functools.lru_cache(maxsize=8)\ndef build_for(cfg: Cfg):\n"
         "    return cfg.n", "non-frozen dataclass"),
        ("def lookup(graph_cache, cfg: Cfg):\n    return graph_cache[cfg]",
         "non-frozen dataclass"),
        ("def lookup(bucket_cache, ws):\n"
         "    return bucket_cache.get([w for w in ws])", "unhashable"),
        ("def route(lengths):\n"
         "    record_launch('paged_decode', 'kernel', [8, 8])",
         "not a host int"),
        ("def route(q, lengths):\n"
         "    record_launch('paged_decode', 'kernel', q.shape[0], "
         "torch.max(lengths))", "not a host int"),
    ])
    def test_ra002_unhashable_key_fires(self, body, needle):
        findings = _analyze(
            "import dataclasses, functools, torch\n\n"
            "@dataclasses.dataclass\nclass Cfg:\n    n: int = 1\n\n\n"
            + body + "\n")
        assert _codes(findings) == ["RA002"]
        assert needle in findings[0].message

    def test_ra002_lru_cached_builder_is_clean(self):
        findings = _analyze("""
            import ctypes, functools
            from repro_torch.kernels import build

            @functools.lru_cache(maxsize=1)
            def library():
                return ctypes.CDLL(str(build.build().path))

            def load():
                return ctypes.CDLL(str(build.build().path))
        """)
        assert findings == []

    @pytest.mark.parametrize("ctor", [
        "torch.Generator()", "torch.cuda.Stream()", "torch.cuda.CUDAGraph()",
        "torch.compile(fn)", "dist.new_group([0, 1])",
        "ctypes.CDLL('lib.so')", "build.build()",
    ])
    def test_ra002_built_per_call_in_a_hot_path_fires(self, ctor):
        findings = _analyze(f"""
            def decode_round(fn, x):
                made = {ctor}
                return made, x
        """)
        assert _codes(findings) == ["RA002"]
        assert "hot-path" in findings[0].message

    # ---- RA003 ----------------------------------------------------------
    def test_ra003_sync_outside_hot_path_is_clean(self):
        findings = _analyze("""
            from repro_torch.models import forward

            def report(cfg, params, tokens):    # not a hot-path name
                logits, _, _ = forward(cfg, params, tokens)
                return float(logits.max())
        """)
        assert findings == []

    @pytest.mark.parametrize("line", [
        "return float(logits.max())",
        "return logits.argmax(-1).tolist()",
        "return logits.cpu()",
        "return np.asarray(logits)",
        "return torch.nonzero(logits > 0)",
        "return 1 if (logits > 0).any() else 0",
        "torch.cuda.synchronize()",
    ])
    def test_ra003_sync_on_a_device_result_fires(self, line):
        findings = _analyze(f"""
            import numpy as np, torch
            from repro_torch.models import decode_step

            def step(cfg, params, pool, tok, pos):
                logits, _ = decode_step(cfg, params, pool, tok, pos)
                {line}
        """)
        assert _codes(findings) == ["RA003"]

    def test_ra003_sync_on_a_host_value_is_clean(self):
        findings = _analyze("""
            import numpy as np, torch

            def step(pos, table):
                width = int(np.asarray(pos).max())
                host = torch.as_tensor(table)
                return width, host.numpy(), int(host.sum())
        """)
        assert findings == []

    def test_ra003_reaches_callees_of_a_hot_path(self):
        # continuous.py's shape: step -> self._round -> self._host_inputs
        findings = _analyze("""
            import torch

            class Engine:
                def _host_inputs(self, arr):
                    return torch.as_tensor(arr).to(self.device)

                def _chunk(self, bt):
                    return torch.stack([self._host_inputs(bt)])

                def _round(self, bt):
                    toks = self._chunk(bt)
                    return toks.cpu().numpy()

                def step(self, bt):
                    return self._round(bt)

                def stats(self, bt):            # not reached from step
                    return self._chunk(bt).cpu()
        """)
        assert [(f.rule, f.line) for f in findings] == [
            ("RA003", 6), ("RA003", 13)]

    def test_ra003_lines_are_the_lines_a_frame_reports(self):
        """The card's twin maps a sync to its frame's ``f_lineno``: a
        static finding must sit on that line, also for calls over several
        lines."""
        src = textwrap.dedent("""
            import torch
            from repro_torch.models import forward

            def step(cfg, params, tokens, host):
                logits, _, _ = forward(cfg, params, tokens)
                a = logits.argmax(
                    -1).cpu()
                b = torch.as_tensor(
                    host).to(
                        "cpu")
                c = float(
                    logits)
                return a, b, c
        """)
        want = sorted(f.line for f in _analyze(src) if f.rule == "RA003")
        seen = []

        class Rec:
            def argmax(self, *a):
                return self

            def cpu(self, *a):
                seen.append(sys._getframe(1).f_lineno)
                return self

            to = cpu

            def __float__(self):
                seen.append(sys._getframe(1).f_lineno)
                return 0.0

        # the same lines without the imports, run on a recording stand-in
        body = "\n".join("" if line.startswith(("import", "from")) else line
                         for line in src.splitlines())
        ns = {"forward": lambda *a: (Rec(), None, None),
              "torch": type("T", (), {"as_tensor": staticmethod(
                  lambda x: Rec())})}
        exec(compile(body, "mod.py", "exec"), ns)
        ns["step"](None, None, None, None)
        assert len(want) == 3 and seen == want

    def test_ra003_engine_round_sites_fire_without_their_noqa(self):
        rel = "src/repro_torch/sampling/continuous.py"
        text = (REPO / rel).read_text()
        bare = "\n".join(line.split("  # noqa: RA003")[0]
                         for line in text.splitlines())
        f = SourceFile(REPO / rel, rel, bare)
        lines = sorted({fd.line for fd in run_rules([f])
                        if fd.rule == "RA003"})
        marked = [i for i, line in enumerate(text.splitlines(), 1)
                  if "# noqa: RA003" in line]
        assert lines == marked and len(marked) == 4

    # ---- RA004 ----------------------------------------------------------
    KERNEL_FILES = ("paged_attention.py", "flash_attention.py",
                    "fused_logprob.py", "ssd_scan.py")

    @pytest.mark.parametrize("name", KERNEL_FILES)
    def test_ra004_kernel_wrappers_are_clean(self, name):
        rel = f"src/repro_torch/kernels/{name}"
        files = collect_files([REPO / rel], root=REPO)
        launchers = [fn for fn in rules.ast.walk(files[0].tree)
                     if isinstance(fn, rules.ast.FunctionDef)
                     and any(rules._is_launch(n)
                             for n in rules._own_nodes(fn))]
        assert launchers
        assert run_rules(files) == []

    PA = "src/repro_torch/kernels/paged_attention.py"

    @pytest.mark.parametrize("old,new,needle", [
        ("npages, win, cap, code, stream)\n    _raise_on(err, "
         "\"paged_decode_kernel\")",
         "npages, win, cap, code, 0)\n    _raise_on(err, "
         "\"paged_decode_kernel\")", "current_stream"),
        ("    _raise_on(err, \"paged_decode_kernel\")\n",
         "    if err != 0:\n        raise RuntimeError(\"failed\")\n",
         "_raise_on"),
        ("    build.count_launch(LAUNCHES, \"paged_decode\")\n", "",
         "count_launch"),
        ("    if q.device.type != \"cuda\":\n        raise ValueError(f\""
         "paged_attention runs",
         "    q.data_ptr()\n    if q.device.type != \"cuda\":\n"
         "        raise ValueError(f\"paged_attention runs",
         "before any input check"),
        ("    if q.dim() != 3:\n        raise ValueError(f\"q must be "
         "(B, Hq, D), got {tuple(q.shape)}\")\n",
         "    if q.dim() != 3:\n        return paged_decode_ref(q, kp, vp, "
         "page_table, lengths)\n", "outside a `.device.type"),
    ])
    def test_ra004_paged_decode_wrapper_mutations_fire(self, old, new,
                                                        needle):
        findings = _mutated(self.PA, old, new)
        assert findings and all(f.rule == "RA004" for f in findings)
        assert any(needle in f.message for f in findings), findings

    def test_ra004_twin_on_a_build_failure_fires(self):
        findings = _analyze("""
            from repro_torch.kernels import build

            def paged_decode(q, kp, vp, table, lengths):
                try:
                    lib = build.load()
                except OSError:
                    return paged_decode_ref(q, kp, vp, table, lengths)
                return lib
        """, name="src/repro_torch/kernels/mod.py")
        assert _codes(findings) == ["RA004"]
        assert "except" in findings[0].message

    # ---- RA005 ----------------------------------------------------------
    def test_ra005_locked_mutation_is_clean(self):
        findings = _analyze("""
            import threading

            class Shared:
                def __init__(self):
                    self.n = 0
                    self._lock = threading.Lock()

                def bump(self):
                    with self._lock:
                        self.n += 1

                def run(self):
                    threading.Thread(target=self.bump).start()
        """)
        assert findings == []

    def test_ra005_unlocked_mutation_fires(self):
        findings = _analyze("""
            import threading

            class Shared:
                def __init__(self):
                    self.n = 0

                def bump(self):
                    self.n += 1

                def run(self):
                    threading.Thread(target=self.bump).start()
        """)
        assert _codes(findings) == ["RA005"]


class TestSuppressionAndBaseline:
    BAD = """
        from repro_torch.models import forward

        def step(cfg, params, tokens):
            logits, _, _ = forward(cfg, params, tokens)
            return float(logits.max()){noqa}
    """

    @pytest.mark.parametrize("noqa,suppressed", [
        ("", False), ("  # noqa: RA003", True), ("  # noqa", True),
        ("  # noqa: RA003 — once a round", True),
        ("  # noqa: RA001", False),
    ])
    def test_noqa_suppresses_exact_rule(self, noqa, suppressed):
        findings = _analyze(self.BAD.format(noqa=noqa))
        assert (findings == []) == suppressed

    def test_keep_suppressed_returns_noqa_sites(self):
        f = SourceFile(Path("m.py"), "m.py", textwrap.dedent(
            self.BAD.format(noqa="  # noqa: RA003")))
        assert run_rules([f]) == []
        assert _codes(run_rules([f], keep_suppressed=True)) == ["RA003"]

    def test_baseline_roundtrip_and_staleness(self, tmp_path):
        findings = _analyze(self.BAD.format(noqa=""))
        assert findings
        bl_path = tmp_path / "baseline.json"
        save_baseline(bl_path, findings)
        baseline = load_baseline(bl_path)
        assert json.loads(bl_path.read_text())["version"] == 1

        new, stale = apply_baseline(findings, baseline)
        assert new == [] and stale == []

        # key is content-addressed: the same finding on a shifted line
        # is still baselined
        shifted = _analyze("\n\n" + textwrap.dedent(
            self.BAD.format(noqa="")))
        new, stale = apply_baseline(shifted, baseline)
        assert new == []

        # fixing the finding leaves a stale entry (prompt to re-baseline)
        new, stale = apply_baseline([], baseline)
        assert new == [] and len(stale) == len({f.key for f in findings})


class TestRepoIsClean:
    def test_port_analysis_clean_with_checked_in_baseline(self):
        new, stale, _total = run_analysis(
            default_paths(REPO), root=REPO, baseline_path=REPO / BASELINE)
        assert new == [], "new analysis findings:\n" + "\n".join(
            f.render() for f in new)
        assert stale == [], f"stale baseline entries: {stale}"

    def test_default_paths_cover_the_port(self):
        rels = {f.rel for f in collect_files(default_paths(REPO), root=REPO)}
        assert "chip_smoke.py" in rels
        assert "tests/test_torch_analysis.py" in rels
        assert "src/repro_torch/sampling/continuous.py" in rels
        assert not any(r.startswith("src/repro/") for r in rels)

    def test_cli_selftest_passes_without_jax(self):
        code = ("import sys\n"
                "from repro_torch.analysis.__main__ import main\n"
                "rc = main(['--selftest'])\n"
                "bad = [m for m in sys.modules if m == 'jax' or "
                "m.startswith('jax.') or m == 'repro' or "
                "m.startswith('repro.')]\n"
                "assert not bad, bad\n"
                "sys.exit(rc)\n")
        proc = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO, capture_output=True,
            text=True, timeout=120,
            env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "selftest OK: all 5 rules fired" in proc.stdout

    def test_cli_exit_codes(self, tmp_path):
        bad = tmp_path / "bad.py"
        bad.write_text(textwrap.dedent(TestSuppressionAndBaseline.BAD.format(
            noqa="")))
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
        run = [sys.executable, "-m", "repro_torch.analysis", "--root",
               str(tmp_path)]
        assert subprocess.run(run + ["bad.py"], env=env, capture_output=True,
                              timeout=120).returncode == 1
        assert subprocess.run(run + ["--write-baseline", "bad.py"], env=env,
                              capture_output=True,
                              timeout=120).returncode == 0
        assert subprocess.run(run + ["bad.py"], env=env, capture_output=True,
                              timeout=120).returncode == 0
        assert subprocess.run(run + ["missing.py"], env=env,
                              capture_output=True,
                              timeout=120).returncode == 2


class TestConfigHashability:
    """RA002's dynamic twin: every config and plan that keys a cache or a
    launch shape must be frozen and hash, every field with it."""

    def _configs(self):
        from repro_torch.config import (ATTN, MLP, HeteroConfig,
                                        ModelConfig, RLConfig, ServeConfig,
                                        TrainConfig)
        model = ModelConfig(name="t", family="dense", num_layers=1,
                            d_model=8, num_heads=2, num_kv_heads=1,
                            d_ff=16, vocab_size=8, block_pattern=(ATTN,),
                            ffn_pattern=(MLP,))
        return [model, RLConfig(), TrainConfig(), HeteroConfig(),
                ServeConfig()]

    def test_default_instances_hash(self):
        for cfg in self._configs():
            hash(cfg)

    def test_every_field_value_hashable(self):
        for cfg in self._configs():
            for f in dataclasses.fields(cfg):
                v = getattr(cfg, f.name)
                try:
                    hash(v)
                except TypeError:
                    pytest.fail(f"{type(cfg).__name__}.{f.name} = {v!r} is "
                                "unhashable")

    def test_configs_are_frozen(self):
        for cfg in self._configs():
            with pytest.raises(dataclasses.FrozenInstanceError):
                setattr(cfg, dataclasses.fields(cfg)[0].name, None)

    def test_execution_plan_hashes(self):
        from repro_torch.parallel import plan_from_flag
        plan = plan_from_flag(None, "serve", "cpu")
        hash(plan)
        assert plan == plan_from_flag(None, "serve", "cpu")
        with pytest.raises(dataclasses.FrozenInstanceError):
            plan.mode = "train"


class TestHostSyncTwin:
    """chip_smoke.py's phase 18 on synthetic card reports: the matching
    and the phase's verdicts run here; only the syncs need the card."""

    REL = "src/repro_torch/sampling/continuous.py"

    def _lines(self, needle):
        text = (REPO / self.REL).read_text().splitlines()
        return [i for i, line in enumerate(text, 1) if needle in line]

    def _rounds(self, extra=()):
        tensor = self._lines("return torch.as_tensor(arr).to(")[0]
        fetch = self._lines("tok_np, lp_np = toks.cpu()")[0]
        site = (self.REL, tensor, "_tensor")
        prng = ("src/repro_torch/sampling/prng.py", 1, "uniform")
        decode = [(site, (self.REL, 400, "_decode_chunk"))] * 6 \
            + [((self.REL, fetch, "step"),)] * 2 + [(prng,)] + list(extra)
        return [("prefill", [(site,)] * 2 + decode), ("decode", decode)]

    def _smoke(self):
        sys.path.insert(0, str(REPO))
        try:
            import chip_smoke
        finally:
            sys.path.remove(str(REPO))
        return chip_smoke

    def test_covered_sites_pass_and_a_bare_hot_site_fails(self):
        cs = self._smoke()
        files = collect_files(default_paths(REPO), root=REPO)
        found = run_rules(files, keep_suppressed=True)
        rows, unmatched, unhit = cs.match_twin(self._rounds(), files, found)
        assert unmatched == []
        verdicts = {s[1]: (hot, covered) for s, _, hot, covered in rows}
        assert verdicts[1] == (False, False)          # prng: not hot
        assert sorted(v for v in verdicts.values() if v[0]) == [
            (True, True), (True, True)]
        assert (self.REL, self._lines("io, fo = iout.cpu()")[0]) in unhit
        assert cs.round_syncs(self._rounds(), "decode") == [9]
        # a sync inside step on a line no static finding covers
        bare = (self.REL, self._lines("dec = sched.decoding()")[0], "step")
        _, unmatched, _ = cs.match_twin(self._rounds([(bare,)]), files,
                                        found)
        assert unmatched == [bare]

    def test_analysis_phase_holds_the_twin(self):
        cs = self._smoke()
        cs.analysis_phase(self._rounds())
        bare = (self.REL, self._lines("dec = sched.decoding()")[0], "step")
        with pytest.raises(AssertionError, match="no static RA003"):
            cs.analysis_phase(self._rounds([(bare,)]))


PARITY_DIRS = ("src/repro_torch/hetero", "src/repro_torch/serving")


def _parity_files():
    """The same sources parsed by both packages: the reference fixture and
    the port's hetero/ and serving/."""
    paths = [REF_FIXTURE, *(REPO / d for d in PARITY_DIRS)]
    return (ref_core.collect_files(paths, root=REPO, excludes=()),
            collect_files(paths, root=REPO, excludes=()))


def _as_tuple(fd):
    return (fd.rule, fd.path, fd.line, fd.message, fd.snippet, fd.key,
            fd.render())


class TestParityWithReference:
    def test_collect_files_and_noqa_maps_equal(self):
        theirs, ours = _parity_files()
        assert [f.rel for f in ours] == [f.rel for f in theirs]
        assert len(ours) > 10
        for a, b in zip(theirs, ours):
            assert b.noqa == a.noqa, b.rel
            assert b.lines == a.lines

    def test_default_excludes_equal(self):
        assert DEFAULT_EXCLUDES == ref_core.DEFAULT_EXCLUDES
        paths = [REPO / "src" / "repro" / "analysis", PORT / "analysis"]
        assert [f.rel for f in collect_files(paths, root=REPO)] == [
            f.rel for f in ref_core.collect_files(paths, root=REPO)]

    def test_ra005_findings_equal(self):
        theirs, ours = _parity_files()
        a = ref_core.run_rules(theirs,
                               [ref_rules.UnlockedCrossThreadMutation()])
        b = run_rules(ours, [rules.UnlockedCrossThreadMutation()])
        assert [_as_tuple(f) for f in b] == [_as_tuple(f) for f in a]
        assert any(f.path.endswith("known_bad.py") for f in b)

    def test_finding_key_and_apply_baseline_equal(self, tmp_path):
        theirs, ours = _parity_files()
        a = ref_core.run_rules(theirs,
                               [ref_rules.UnlockedCrossThreadMutation()])
        b = [Finding(f.rule, f.path, f.line, f.message, f.snippet)
             for f in a]
        assert [f.key for f in b] == [f.key for f in a]
        ref_core.save_baseline(tmp_path / "ref.json", a[:1] + a)
        save_baseline(tmp_path / "port.json", b[:1] + b)
        assert (tmp_path / "port.json").read_text() == \
            (tmp_path / "ref.json").read_text()
        baseline = load_baseline(tmp_path / "ref.json")
        assert baseline == ref_core.load_baseline(tmp_path / "port.json")
        for subset in (a, a[1:], a + a[:1], []):
            ra_new, ra_stale = ref_core.apply_baseline(subset, baseline)
            pb = [Finding(f.rule, f.path, f.line, f.message, f.snippet)
                  for f in subset]
            new, stale = apply_baseline(pb, baseline)
            assert [f.key for f in new] == [f.key for f in ra_new]
            assert stale == ra_stale

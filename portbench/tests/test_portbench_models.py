"""The check's fold and align references are found by name, one file a
model (`reference/fold/<name>.py`, `reference/align/<name>.py`): a
configuration of other models joins the benchmark by added files alone, and
one whose model has no file fails when its cell is loaded."""

from __future__ import annotations

import json
import os
import re
import time

import numpy as np
import pytest

from conftest import ROOT, TINY_FA
from portbench import harness
from portbench.reference import family

SEQS = [blk.split("\n", 1)[1].strip() for blk in TINY_FA.strip().lstrip(">").split("\n>")]
MODELS = [(kind, name[:-3])
          for kind in ("fold", "align")
          for name in sorted(os.listdir(os.path.join(ROOT, "portbench", "reference", kind)))
          if name.endswith(".py")]

# Test-only references of the CONTRA models: the port's plain versions, so
# that on the CPU they agree with the port bit for bit.
STUBS = dict(
    fold=("CONTRAfold", '''
from dafs_tpu_torch.ops import contrafold

CONSENSUS_LEAVES = False


def posteriors(seqs, device):
    return contrafold.batch_bp_posteriors(seqs, 0.0, device)
'''),
    align=("CONTRAlign", '''
from dafs_tpu_torch.ops import paircrf


def posteriors(seqs1, seqs2, th_a, device):
    return paircrf.batch_posteriors(seqs1, seqs2, th_a, device)
'''))


def _add_stubs(root, kinds=("fold", "align")):
    for kind in kinds:
        name, text = STUBS[kind]
        with open(family.model_file(kind, name, root), "w") as fh:
            fh.write(text)


def _run(cell, seed=2**31 + 29):
    line, lines = harness.run_cell(cell, seed, 0.1, False, "cpu", time.perf_counter())
    return line, "\n".join(lines)


@pytest.mark.parametrize("kind,name", MODELS, ids=lambda v: v)
def test_model_reference_equals_the_plain_port(kind, name):
    """Each model file against the port's model of that name on the CPU,
    where the port runs its plain versions: the same bits."""
    from dafs_tpu_torch.models import align_models, fold_models

    mod = family.load_model(kind, name)
    if kind == "fold":
        got = mod.posteriors(SEQS, "cpu")
        want = fold_models.by_name(name, 0.0).batch_bp_posteriors(SEQS, "cpu", th=0.0)
        # the consensus of one sequence takes the fold's posteriors exactly
        # where `Dafs.run` hands them over: McCaskill under the consensus's
        # parameters (BL* under "Boltzmann", as `api.make_dafs` builds it)
        s_model = fold_models.by_name(name, 0.0)
        assert mod.CONSENSUS_LEAVES is (isinstance(s_model, fold_models.RNAfold)
                                        and s_model.bl == (name == "Boltzmann"))
    else:
        pairs = [(i, j) for i in range(len(SEQS)) for j in range(i + 1, len(SEQS))]
        s1, s2 = [SEQS[i] for i, _ in pairs], [SEQS[j] for _, j in pairs]
        got = mod.posteriors(s1, s2, 0.01, "cpu")
        want = align_models.by_name(name, 0.01).batch_pair_posteriors(s1, s2, "cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and np.array_equal(g, w)


def test_a_configuration_joins_by_added_files(tiny_cell):
    """The CONTRAfold + CONTRAlign configuration on the tiny cell, its
    references added as files in the cell's own (temporary) folder and no
    file of `portbench/` edited: the run is correct, every number at 0."""
    _add_stubs(tiny_cell.root)
    line, lines = _run(tiny_cell("dafs-contra"))
    assert line["correct"], lines
    assert all(v["value"] == 0 for v in line["checks"].values()), lines


def test_a_configuration_of_added_files_sees_its_fold_altered(tiny_cell, monkeypatch):
    """The same, the program's CONTRAfold posteriors altered where they are
    produced: the added references catch it."""
    from dafs_tpu_torch.models import fold_models

    orig = fold_models.CONTRAfold.batch_bp_posteriors

    def scaled(self, *a, **k):
        return [p * np.float32(0.9) for p in orig(self, *a, **k)]

    monkeypatch.setattr(fold_models.CONTRAfold, "batch_bp_posteriors", scaled)
    _add_stubs(tiny_cell.root)
    line, lines = _run(tiny_cell("dafs-contra"))
    assert not line["correct"], lines
    assert line["checks"]["bp_err"]["value"] > line["checks"]["bp_err"]["limit"]


@pytest.mark.parametrize("missing", ["fold", "align"])
def test_a_model_without_reference_fails_at_cell_load(tiny_cell, tmp_path, missing):
    """A configuration naming a model that has no reference file stops at
    the cell's load, before any set-up, and names the missing path."""
    conf = harness.load_json(ROOT, "portbench", "configs", "dafs-default.json")
    conf.update(name="unreferenced", **{f"{missing}_model": "Unreferenced"})
    path = tmp_path / "unreferenced.json"
    path.write_text(json.dumps(conf))
    want = family.model_file(missing, "Unreferenced", tiny_cell.root)
    with pytest.raises(SystemExit, match=re.escape(want)):
        tiny_cell("unreferenced", file=str(path))

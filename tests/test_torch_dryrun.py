"""The whole pipeline on a work mesh on the CPU: `Dafs.run` on a virtual
mesh against one device, and `parallel.dryrun` (the port of
`__graft_entry__.py`: the compile check and the multichip dry run of three
configurations, each byte-equal to its single-device run).
"""

import pytest
import torch

from dafs_tpu_torch.parallel import dryrun, mesh

# pytest-xdist runs several test processes side by side; torch's own
# intra-op threads in each of them would oversubscribe the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")


def test_dafs_run_on_a_virtual_mesh():
    """`Dafs.run` under virtual_mesh(3) is byte-equal to the single-device
    run and to the run under force_single_device()."""
    fam = dryrun.synthetic_family()
    with mesh.virtual_mesh(3):
        assert mesh.work_device_count(CPU) == 3
        sharded = dryrun.make_engine("default", CPU).run(fam)
    single = dryrun.make_engine("default", CPU).run(fam)
    with mesh.virtual_mesh(3), mesh.force_single_device():
        forced = dryrun.make_engine("default", CPU).run(fam)
    assert ">SS_cons" in sharded
    assert sharded == single == forced


@pytest.mark.parametrize("config", [
    "default",
    pytest.param("ipknot", marks=pytest.mark.slow),
    pytest.param("contrafold", marks=pytest.mark.slow),
])
def test_dryrun_multichip(config, capsys):
    lines = dryrun.dryrun_multichip(2, CPU, configs=(config,))
    assert len(lines) == 1 and f"ok [{config}]" in lines[0]
    assert lines[0] in capsys.readouterr().out


def test_entry_runs_the_pair_hmm():
    fn, args = dryrun.entry(CPU)
    post = fn(*args)
    assert post.shape == (2, 32, 32) and bool(torch.isfinite(post).all())
    assert float(post.max()) > 0.5

"""The result line, and the output check against the faults a cell can
have: the timed path broken underneath, the rest of a run driven on the
CPU, ``correct`` has to come out false."""
import pytest
import torch

from portbench.core import registry

from conftest import run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", ["tfi.tiny", "xxz.tiny"])
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys(tiny_root, cell, trace):
    code, res = run_cell(tiny_root, cell, trace=trace)
    assert code == 0 and res["correct"] is True
    keys = KEYS + (["breakdown"] if trace else []) + ["build_s", "checks"]
    assert list(res) == keys
    assert res["attempted"] == registry.workload(cell, tiny_root[0])["batch"]
    assert res["failed"] == 0
    limits = registry.workload(cell, tiny_root[0])["limits"]
    assert list(res["checks"]) == list(limits)
    for name, c in res["checks"].items():
        assert c["limit"] == limits[name] and 0 <= c["value"] <= c["limit"]
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "host_enqueue_ms" in res["metrics"]
    else:
        assert set(res["metrics"]) == {"sweep_rate", "setup_s"}
        for m in res["metrics"].values():
            assert m["value"] > 0


def _dense_fault(kind, limit):
    from tensornetwork_tpu_torch.models import dmrg
    orig = dmrg._one_site_sweep_impl

    def broken(As, *args, **kwargs):
        res = orig(As, *args, **kwargs)
        h = As.shape[0] // 2
        if kind == "unchanged":
            return res._replace(As=As)
        if kind == "half":
            e = res.energy.clone()
            e[h:] = res.energy[:h].mean()
            return res._replace(As=torch.cat([res.As[:h], As[h:]]),
                                energy=e)
        e = res.energy.clone()
        e[0] += 10 * limit
        return res._replace(energy=e)

    return dmrg, "_one_site_sweep_impl", broken


def _blocksparse_fault(kind, limit):
    from tensornetwork_tpu_torch.models.symmetric_dmrg_batched import (
        BatchedSymmetricDMRG)
    orig = BatchedSymmetricDMRG.sweep_one_site

    def broken(self, Rdata):
        before = [d.clone() for d in self.data]
        es = orig(self, Rdata).clone()
        h = self.B // 2
        if kind == "unchanged":
            self.data[:] = before
        elif kind == "half":
            for d, b in zip(self.data, before):
                d[h:] = b[h:]
            es[h:] = es[:h].mean()
        else:
            es[0] += 10 * limit
        return es

    return BatchedSymmetricDMRG, "sweep_one_site", broken


@pytest.mark.parametrize("cell,fault", [("tfi.tiny", _dense_fault),
                                        ("xxz.tiny", _blocksparse_fault)])
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_a_broken_sweep_is_not_correct(tiny_root, monkeypatch, cell, fault,
                                       kind):
    limit = registry.workload(cell, tiny_root[0])["limits"]["ritz_gap"]
    owner, attr, broken = fault(kind, limit)
    monkeypatch.setattr(owner, attr, broken)
    code, res = run_cell(tiny_root, cell)
    assert code == 0
    assert res["correct"] is False and res["failed"] >= 1
    # a state left behind fails its energy against the reference's ground
    # energy, whatever energies the sweep returns with it
    caught = res["checks"]["excess" if kind != "altered" else "ritz_gap"]
    assert caught["value"] > caught["limit"]

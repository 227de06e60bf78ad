"""chip_smoke.py's engine and net phases at small sizes on the CPU: the
same comparisons the GPU run makes at deployment sizes."""

import chip_smoke as cs


def test_phase_betting_small():
    res = cs.phase_betting(cs.SMALL)
    assert res["ok"], res
    for rules, det in res["det_vs_step_table"].items():
        assert det["differing"] == 0 and det["compared"] > 0, rules
    assert res["packed_engine"]["overflow"] == 0


def test_phase_net_small():
    res = cs.phase_net(cs.SMALL)
    assert res["ok"], res
    assert res["matmul_precision"] == "HIGHEST"
    assert res["det_vs_xla_net"]["differing"] == 0


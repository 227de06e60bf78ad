"""chip_smoke.py's solver phase at a small size on the CPU."""

import chip_smoke as cs


def test_phase_solver_small():
    res = cs.phase_solver(cs.SMALL)
    assert res["ok"], res
    assert res["gap_bb"] < res["gap_bb_after_1"]


def test_turn_sizes_are_the_engine_menu():
    from montecarlo_tpu.models.turn_solver import turn_river_node_states

    board4 = cs.turn_board()
    _, _, sizes = turn_river_node_states(
        board4, rivers=[r for r in range(52) if r not in board4][:1])
    assert sizes == cs.TURN_SIZES

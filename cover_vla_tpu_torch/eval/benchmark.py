"""Benchmark registry: case-insensitive suite -> task list mapping.

Mirrors CoVer_VLA/inference/experiments/robot/simpler/simpler_benchmark.py
(register_benchmark/get_benchmark :6-14, task_map :19-59): `simpler_widowx`
is the 4-task ID suite, `simpler_ood` the 3-task OOD suite.
"""

from __future__ import annotations

from typing import Callable, Dict, List

BENCHMARK_MAPPING: Dict[str, type] = {}


def register_benchmark(cls):
    # register by class attribute (instantiating here would import env
    # factories at module-import time and create cycles)
    BENCHMARK_MAPPING[cls.name.lower()] = cls
    return cls


def get_benchmark(name: str):
    key = name.lower()
    if key in BENCHMARK_MAPPING:
        return BENCHMARK_MAPPING[key]
    # any registry env name is selectable as its own single-task suite
    if key in _ALL_ENV_NAMES:
        TASK_MAP[key] = [key]
        return _suite(key)
    raise KeyError(f"unknown benchmark {name!r}")


TASK_MAP: Dict[str, List[str]] = {
    "simpler_widowx": [
        "widowx_put_eggplant_in_basket",
        "widowx_spoon_on_towel",
        "widowx_stack_cube",
        "widowx_carrot_on_plate",
    ],
    "simpler_stack_cube": ["widowx_stack_cube"],
    "simpler_put_eggplant_in_basket": ["widowx_put_eggplant_in_basket"],
    "simpler_spoon_on_towel": ["widowx_spoon_on_towel"],
    "simpler_carrot_on_plate": ["widowx_carrot_on_plate"],
    "simpler_redbull_on_plate": ["widowx_redbull_on_plate"],
    "simpler_carrot_on_plate_unseen_lighting": [
        "widowx_carrot_on_plate_unseen_lighting"],
    "simpler_tennis_ball_in_basket": ["widowx_tennis_ball_in_basket"],
    "simpler_toy_dinosaur_on_towel": ["widowx_toy_dinosaur_on_towel"],
    "simpler_zucchini_on_towel": ["widowx_zucchini_on_towel"],
    "simpler_ood": [
        "widowx_redbull_on_plate",
        "widowx_zucchini_on_towel",
        "widowx_tennis_ball_in_basket",
    ],
    # google-robot (fractal/EDR) suites — SimplerEnv visual-matching set
    # (simpler_env/__init__.py:43-91), driven by the EDR adapters
    # (eval/fractal_adapters.py)
    "simpler_google_pick_coke_can": [
        "google_robot_pick_coke_can",
        "google_robot_pick_horizontal_coke_can",
        "google_robot_pick_vertical_coke_can",
        "google_robot_pick_standing_coke_can",
    ],
    "simpler_google_move_near": ["google_robot_move_near"],
    "simpler_google_drawer": [
        "google_robot_open_top_drawer",
        "google_robot_open_middle_drawer",
        "google_robot_open_bottom_drawer",
        "google_robot_close_top_drawer",
        "google_robot_close_middle_drawer",
        "google_robot_close_bottom_drawer",
    ],
    "simpler_google_place_in_drawer": [
        "google_robot_place_apple_in_closed_top_drawer",
    ],
    "simpler_google_robot": [
        "google_robot_pick_coke_can",
        "google_robot_pick_horizontal_coke_can",
        "google_robot_pick_vertical_coke_can",
        "google_robot_pick_standing_coke_can",
        "google_robot_move_near",
        "google_robot_open_top_drawer",
        "google_robot_open_middle_drawer",
        "google_robot_open_bottom_drawer",
        "google_robot_close_top_drawer",
        "google_robot_close_middle_drawer",
        "google_robot_close_bottom_drawer",
        "google_robot_place_apple_in_closed_top_drawer",
    ],
    # remaining custom OOD scenes
    "simpler_tape_measure_in_basket": ["widowx_tape_measure_in_basket"],
    "simpler_stapler_on_paper": ["widowx_stapler_on_paper"],
    "simpler_spoon_on_towel_new_table_cloth": [
        "widowx_spoon_on_towel_new_table_cloth"],
    "simpler_spoon_on_towel_google": ["widowx_spoon_on_towel_google"],
}

# every env name known to the registry (single-task suite synthesis)
_ALL_ENV_NAMES = {
    "google_robot_pick_coke_can", "google_robot_pick_horizontal_coke_can",
    "google_robot_pick_vertical_coke_can",
    "google_robot_pick_standing_coke_can", "google_robot_pick_object",
    "google_robot_move_near", "google_robot_move_near_v0",
    "google_robot_move_near_v1", "google_robot_open_drawer",
    "google_robot_open_top_drawer", "google_robot_open_middle_drawer",
    "google_robot_open_bottom_drawer", "google_robot_close_drawer",
    "google_robot_close_top_drawer", "google_robot_close_middle_drawer",
    "google_robot_close_bottom_drawer",
    "google_robot_place_in_closed_drawer",
    "google_robot_place_in_closed_top_drawer",
    "google_robot_place_in_closed_middle_drawer",
    "google_robot_place_in_closed_bottom_drawer",
    "google_robot_place_apple_in_closed_top_drawer",
    "widowx_spoon_on_towel", "widowx_carrot_on_plate", "widowx_stack_cube",
    "widowx_put_eggplant_in_basket",
    "widowx_carrot_on_plate_unseen_lighting",
    "widowx_spoon_on_towel_new_table_cloth", "widowx_spoon_on_towel_google",
    "widowx_redbull_on_plate", "widowx_tennis_ball_in_basket",
    "widowx_zucchini_on_towel", "widowx_tape_measure_in_basket",
    "widowx_toy_dinosaur_on_towel", "widowx_stapler_on_paper",
    # appearance-only tier of the fake-env OOD suite (color/size shift
    # without the round-5 geometry/clutter axes; fake_env.TASK_APPEARANCES)
    "widowx_redbull_on_plate_appearance",
    "widowx_tennis_ball_in_basket_appearance",
    "widowx_zucchini_on_towel_appearance",
}

# canonical language instruction per task (what env.get_language_instruction
# returns in SIMPLER for these scenes; keys of the rephrase store)
TASK_INSTRUCTIONS: Dict[str, str] = {
    "widowx_carrot_on_plate": "put carrot on plate",
    "widowx_carrot_on_plate_unseen_lighting": "put carrot on plate",
    "widowx_put_eggplant_in_basket": "put eggplant into yellow basket",
    "widowx_spoon_on_towel": "put the spoon on the towel",
    "widowx_stack_cube": "stack the green block on the yellow block",
    "widowx_redbull_on_plate": "put redbull can on plate",
    "widowx_redbull_on_plate_appearance": "put redbull can on plate",
    "widowx_zucchini_on_towel": "put the zucchini on the towel",
    "widowx_zucchini_on_towel_appearance": "put the zucchini on the towel",
    "widowx_toy_dinosaur_on_towel": "put the toy dinosaur on the towel",
    "widowx_tennis_ball_in_basket": "put tennis ball into yellow basket",
    "widowx_tennis_ball_in_basket_appearance":
        "put tennis ball into yellow basket",
    "widowx_tape_measure_in_basket": "put tape measure into yellow basket",
    "widowx_stapler_on_paper": "put the stapler on the paper",
    "widowx_spoon_on_towel_new_table_cloth": "put the spoon on the towel",
    "widowx_spoon_on_towel_google": "put the spoon on the towel",
    # google-robot fallbacks (the real envs generate these at reset;
    # move_near's is episode-dependent)
    "google_robot_pick_coke_can": "pick coke can",
    "google_robot_pick_horizontal_coke_can": "pick coke can",
    "google_robot_pick_vertical_coke_can": "pick coke can",
    "google_robot_pick_standing_coke_can": "pick coke can",
    "google_robot_pick_object": "pick object",
    "google_robot_move_near": "move the object near the other object",
    "google_robot_move_near_v0": "move the object near the other object",
    "google_robot_move_near_v1": "move the object near the other object",
    "google_robot_open_drawer": "open the drawer",
    "google_robot_open_top_drawer": "open top drawer",
    "google_robot_open_middle_drawer": "open middle drawer",
    "google_robot_open_bottom_drawer": "open bottom drawer",
    "google_robot_close_drawer": "close the drawer",
    "google_robot_close_top_drawer": "close top drawer",
    "google_robot_close_middle_drawer": "close middle drawer",
    "google_robot_close_bottom_drawer": "close bottom drawer",
    "google_robot_place_in_closed_drawer":
        "place the object into the closed drawer",
    "google_robot_place_in_closed_top_drawer":
        "place the object into the closed top drawer",
    "google_robot_place_in_closed_middle_drawer":
        "place the object into the closed middle drawer",
    "google_robot_place_in_closed_bottom_drawer":
        "place the object into the closed bottom drawer",
    "google_robot_place_apple_in_closed_top_drawer":
        "place apple into top drawer",
}


class Benchmark:
    name: str = ""
    env_fn: Callable = None
    state_dim: int = 7

    def __init__(self):
        self.tasks = TASK_MAP.get(self.name, [])

    def get_task(self, i: int) -> str:
        return self.tasks[i]

    @property
    def n_tasks(self) -> int:
        return len(self.tasks)

    def make(self, task_name: str, **kwargs):
        return self.env_fn(task_name, **kwargs)


def _suite(suite_name: str):
    @register_benchmark
    class _S(Benchmark):
        name = suite_name

        def __init__(self):
            super().__init__()
            from cover_vla_tpu_torch.eval.fake_env import make_fake_env
            self.env_fn = make_fake_env
    _S.__name__ = f"Benchmark_{suite_name}"
    return _S


for _name in TASK_MAP:
    _suite(_name)

"""Dataset split configurations for the CAPE release.

Counterpart of `cape_tpu.data.dataset_configs` (copied: the port imports
nothing of the JAX package). The subjects, sequence partitions and
exclusions of the reference's data/dataset_configs.py, built by a small
helper so that a new split is declarative.
"""

from __future__ import annotations

# motion sequences shared by most subjects
SEQS_GROUP1 = [
    "ballerina_spin", "ATUsquat", "basketball", "bend_back_and_front",
    "bend_twist", "chicken_wings", "flying_eagle", "hips", "improvise",
    "jumping_jacks", "move_arms", "move_shoulders", "pose_model", "punching",
    "ROM_lower", "ROM_upper", "rotate_hips", "running_on_the_spot",
    "shoulders_mill", "simple", "soccer", "squats", "twist_tilt",
    "tilt_twist_left", "twist_tilt_left", "walk_march",
]
TEST_SEQS_GROUP1 = ["ballerina_spin", "soccer", "pose_model", "bend_twist"]
TRAIN_SEQS_GROUP1 = sorted(set(SEQS_GROUP1) - set(TEST_SEQS_GROUP1))

# subjects 00134 / 03375 use two-trial sequences
_G2_TRAIN = [
    "athletics", "ATUsquat", "badminton", "basketball", "ballet1", "box",
    "frisbee", "golf", "row", "swim", "twist_tilt", "volleyball",
]
_G2_TEST_UNSEEN = ["twist", "soccer"]   # both trials excluded from training
_G2_TEST_SEEN = ["climb", "ski"]        # trial1 trains, trial2 tests
TRAIN_SEQS_GROUP2 = sorted(f"{s}_trial1" for s in (_G2_TRAIN + _G2_TEST_SEEN))
TEST_SEQS_GROUP2 = sorted(f"{s}_trial2" for s in _G2_TEST_UNSEEN) + sorted(
    f"{s}_trial2" for s in _G2_TEST_SEEN
)

ALL_CLOTH_TYPES = ["shortlong", "longshort", "shortshort", "longlong"]


def make_split(train_subjs, test_subjs, train_seqs, test_seqs, **overrides) -> dict:
    cfg = {
        "cut_first": 2,
        "sample_rate": 1,
        "train_subjs": train_subjs,
        "train_seqs": train_seqs,
        "train_cloth": list(ALL_CLOTH_TYPES),
        "exclude_seqs": ["running_on_the_spot", "jumping_jacks"],
        "exclude_cases": [],
        "test_subjs": test_subjs,
        "test_seqs": test_seqs,
        "test_cloth": list(ALL_CLOTH_TYPES),
    }
    cfg.update(overrides)
    return cfg


_FEMALE_SUBJS = ["00159", "00134", "03223", "03331"]
_MALE_SUBJS = ["03284", "00215", "00127", "00122", "00032", "02474", "03394"]

dataset_config_dicts = {
    "female": make_split(
        _FEMALE_SUBJS, _FEMALE_SUBJS,
        TRAIN_SEQS_GROUP1 + TRAIN_SEQS_GROUP2,
        TEST_SEQS_GROUP1 + TEST_SEQS_GROUP2,
    ),
    "male": make_split(
        _MALE_SUBJS, _MALE_SUBJS, TRAIN_SEQS_GROUP1, TEST_SEQS_GROUP1
    ),
}

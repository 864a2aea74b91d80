from .dataset_env import DatasetEnv
from .game import Game
from .keymap import get_keymap_and_action_names
from .play_env import NamedEnv, PlayEnv

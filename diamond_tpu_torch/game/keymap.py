"""Keyboard chord -> action maps for the play app (diamond_tpu/game/keymap.py).

The Atari action names and their pygame key chords; a game's keymap comes from its env's
action meanings where gymnasium can make the env (ale-py for real ALE ids, the port's
scripted ALE double for ``FakeALE*`` ids, envs/fake_ale.py), else from a static table of
common games; the synthetic Fake env has a keymap of its own. pygame is needed only for
the chord maps, and is imported when one is made: the names and meanings work without it
(the card's machine has no pygame; play runs headless there).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

ATARI_ACTION_NAMES = [
    "NOOP", "FIRE", "UP", "RIGHT", "LEFT", "DOWN", "UPRIGHT", "UPLEFT", "DOWNRIGHT",
    "DOWNLEFT", "UPFIRE", "RIGHTFIRE", "LEFTFIRE", "DOWNFIRE", "UPRIGHTFIRE", "UPLEFTFIRE",
    "DOWNRIGHTFIRE", "DOWNLEFTFIRE",
]


def _pygame():
    """pygame, or None where it is not installed."""
    try:
        import pygame
    except ImportError:
        return None
    return pygame


def _atari_chords() -> Dict[str, Tuple[int, ...]]:
    k = _pygame().key.key_code
    return {
        "NOOP": (),
        "FIRE": (k("space"),),
        "UP": (k("up"),),
        "RIGHT": (k("right"),),
        "LEFT": (k("left"),),
        "DOWN": (k("down"),),
        "UPRIGHT": (k("up"), k("right")),
        "UPLEFT": (k("up"), k("left")),
        "DOWNRIGHT": (k("down"), k("right")),
        "DOWNLEFT": (k("down"), k("left")),
        "UPFIRE": (k("up"), k("space")),
        "RIGHTFIRE": (k("right"), k("space")),
        "LEFTFIRE": (k("left"), k("space")),
        "DOWNFIRE": (k("down"), k("space")),
        "UPRIGHTFIRE": (k("up"), k("right"), k("space")),
        "UPLEFTFIRE": (k("up"), k("left"), k("space")),
        "DOWNRIGHTFIRE": (k("down"), k("right"), k("space")),
        "DOWNLEFTFIRE": (k("down"), k("left"), k("space")),
    }


# Minimal-action-set meanings of common Atari-100k games (ALE's reduced action spaces),
# for when the env cannot be made (no ale-py).
STATIC_ACTION_MEANINGS: Dict[str, List[str]] = {
    "BreakoutNoFrameskip-v4": ["NOOP", "FIRE", "RIGHT", "LEFT"],
    "PongNoFrameskip-v4": ["NOOP", "FIRE", "RIGHT", "LEFT", "RIGHTFIRE", "LEFTFIRE"],
    "BoxingNoFrameskip-v4": ATARI_ACTION_NAMES,
    "FreewayNoFrameskip-v4": ["NOOP", "UP", "DOWN"],
}


def get_action_meanings(env_id: str) -> List[str]:
    """A game's action meanings, from the env itself where gymnasium can make it (with
    ale-py, or the port's scripted ALE double for ``FakeALE*`` ids), else from
    ``STATIC_ACTION_MEANINGS``."""
    try:
        import gymnasium

        kwargs = {}
        gym_id = env_id
        if env_id.startswith("FakeALE"):
            from ..envs.fake_ale import register_fake_ale

            gym_id = register_fake_ale()
        else:
            import ale_py  # noqa: F401  (registers the ALE ids with gymnasium)

            kwargs = dict(full_action_space=False, frameskip=1)
        env = gymnasium.make(gym_id, **kwargs)
        try:
            return list(env.unwrapped.get_action_meanings())
        finally:
            env.close()
    except Exception:
        if env_id in STATIC_ACTION_MEANINGS:
            return STATIC_ACTION_MEANINGS[env_id]
        raise ValueError(f"Unknown action meanings for {env_id} (ale-py unavailable)")


def get_keymap_and_action_names(keymap_name: str):
    """keymap_name: 'fake' or 'atari/<env-id>' (the config's ``env.keymap``). Returns
    (keymap: dict chord tuple -> action index, action names)."""
    pygame = _pygame()
    assert pygame is not None, "pygame required for the play app's keymaps"
    if keymap_name == "fake":
        k = pygame.key.key_code
        return {(): 0, (k("left"),): 1, (k("right"),): 2}, ["NOOP", "LEFT", "RIGHT"]

    assert keymap_name.startswith("atari/")
    names = get_action_meanings(keymap_name.split("/", 1)[1])
    chords = _atari_chords()
    keymap = {tuple(sorted(chords[name])): i for i, name in enumerate(names)}
    return keymap, names

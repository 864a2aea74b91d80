"""The play app's pygame render and event loop (diamond_tpu/game/game.py): key chords
matched longest first, pause, one step and reset keys, a header panel of the env's
lines, an fps clock. ``run(max_steps)`` stops after that many frames (headless runs with
``SDL_VIDEODRIVER=dummy``). pygame is imported by ``run`` alone.

Keys: Esc quit, Return reset, Period pause/unpause, E one step while paused, and what the
wrapped env's keymap and ``env.key_handler`` take.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np


class Game:
    def __init__(self, play_env: Any, size: Tuple[int, int], fps: int,
                 verbose: bool = True) -> None:
        self.env = play_env
        self.size = size  # (height, width) of the render surface
        self.fps = fps
        self.verbose = verbose
        keymap, action_names = play_env.keymap_and_names()
        # longest chords first, so that UP+FIRE wins over UP
        self.keymap = dict(sorted(keymap.items(), key=lambda kv: -len(kv[0])))
        self.action_names = action_names

    def run(self, max_steps: int = 0) -> None:
        """max_steps > 0 limits the loop (headless smoke tests with SDL_VIDEODRIVER=dummy)."""
        import pygame

        pygame.init()
        h, w = self.size
        header_h = 150
        screen = pygame.display.set_mode((w, h + header_h))
        pygame.display.set_caption("diamond_tpu_torch")
        clock = pygame.time.Clock()
        font = pygame.font.SysFont(None, 22)

        obs, _ = self.env.reset()
        paused = False
        running = True
        steps = 0

        while running:
            steps += 1
            if max_steps and steps > max_steps:
                break
            pygame.event.pump()
            step_once = False
            for event in pygame.event.get():
                if event.type == pygame.QUIT:
                    running = False
                elif event.type == pygame.KEYDOWN:
                    if event.key == pygame.K_ESCAPE:
                        running = False
                    elif event.key == pygame.K_RETURN:
                        obs, _ = self.env.reset()
                    elif event.key == pygame.K_PERIOD:
                        paused = not paused
                    elif event.key == pygame.K_e:
                        step_once = True
                    else:
                        self.env.key_handler(event.key)

            if not paused or step_once:
                pressed = pygame.key.get_pressed()
                act = 0
                for chord, action in self.keymap.items():
                    if all(pressed[k] for k in chord) and len(chord) > 0:
                        act = action
                        break
                obs, rew, end, trunc, info = self.env.step(act)
                if (end or trunc) and self.verbose:
                    print("episode end" if end else "episode truncated")

            frame = self.env.render_frame(obs)
            surf = pygame.surfarray.make_surface(np.transpose(frame, (1, 0, 2)))
            surf = pygame.transform.scale(surf, (w, h))
            screen.fill((30, 30, 30))
            screen.blit(surf, (0, header_h))
            for i, line in enumerate(self.env.header_lines()):
                screen.blit(font.render(line, True, (220, 220, 220)), (8, 8 + 22 * i))
            pygame.display.flip()
            clock.tick(self.fps)

        pygame.quit()

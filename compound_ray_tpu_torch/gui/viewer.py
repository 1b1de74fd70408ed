"""Interactive viewer on the port's EyeRenderer (compound_ray_tpu/gui/
viewer.py): the counterpart of newGuiEyeRenderer.

The reference's GUI (newGuiEyeRenderer/gui.cpp:191-275) is a GLFW window with
fly controls; this viewer uses a matplotlib window with the same key
bindings:

  W/A/S/D       move forward/left/back/right      (BasicController.h:10-43)
  R/F           move up/down
  Q/E           roll left/right
  arrow keys    yaw / pitch
  N / B         next / previous camera            (gui.cpp:120-160)
  PgUp / PgDn   double / halve samples per ommatidium
  C             save frame as PPM
  Esc           quit

Run: python -m compound_ray_tpu_torch.gui.viewer -f scene.gltf
(renders on the card; --device cpu renders on the CPU)

Headless machines get an interactive window through the browser instead:
`--web` serves the same viewer over HTTP via matplotlib's WebAgg backend
(key events travel the browser -> websocket -> mpl key_press_event path,
so the bindings above work unchanged), the counterpart of the reference's
"quick way to validate your model" GL window (README.md:38-40).
matplotlib (and tornado for --web) are imported only by run and run_web,
so the module imports where neither is installed.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Optional

import numpy as np

from compound_ray_tpu_torch.api.renderer import EyeRenderer


class FlyController:
    """Key state -> per-frame movement/rotation (BasicController semantics)."""

    MOVE_SPEED = 0.2
    TURN_SPEED = math.radians(2.0)

    def __init__(self):
        self.pressed = set()

    def press(self, key: str) -> None:
        self.pressed.add(key)

    def release(self, key: str) -> None:
        self.pressed.discard(key)

    def apply(self, renderer: EyeRenderer) -> bool:
        """Apply held keys to the current camera; returns True if moved."""
        moved = False
        step = np.zeros(3)
        if "w" in self.pressed:
            step[2] += self.MOVE_SPEED
        if "s" in self.pressed:
            step[2] -= self.MOVE_SPEED
        if "a" in self.pressed:
            step[0] -= self.MOVE_SPEED
        if "d" in self.pressed:
            step[0] += self.MOVE_SPEED
        if "r" in self.pressed:
            step[1] += self.MOVE_SPEED
        if "f" in self.pressed:
            step[1] -= self.MOVE_SPEED
        if np.any(step != 0):
            renderer.translate_camera_locally(*step)
            moved = True
        cam = renderer.current_camera()
        if "left" in self.pressed:
            cam.rotate_locally_around(self.TURN_SPEED, (0, 1, 0))
            moved = True
        if "right" in self.pressed:
            cam.rotate_locally_around(-self.TURN_SPEED, (0, 1, 0))
            moved = True
        if "up" in self.pressed:
            cam.rotate_locally_around(self.TURN_SPEED, (1, 0, 0))
            moved = True
        if "down" in self.pressed:
            cam.rotate_locally_around(-self.TURN_SPEED, (1, 0, 0))
            moved = True
        if "q" in self.pressed:
            cam.rotate_locally_around(self.TURN_SPEED, (0, 0, 1))
            moved = True
        if "e" in self.pressed:
            cam.rotate_locally_around(-self.TURN_SPEED, (0, 0, 1))
            moved = True
        return moved


class Viewer:
    def __init__(self, renderer: EyeRenderer, width: int = 400, height: int = 300):
        self.renderer = renderer
        self.controller = FlyController()
        self.width = width
        self.height = height
        self.dirty = True
        self.save_count = 0
        renderer.set_render_size(width, height)

    # -- frame production --------------------------------------------------------
    def frame(self) -> np.ndarray:
        """Render if needed; returns the display image (H,W,3) right way up."""
        if self.dirty or self.renderer.is_compound_eye_active():
            self.renderer.render_frame()
            self.dirty = False
        buf = self.renderer.get_frame_pointer()
        return buf[::-1, :, :3]  # buffer row 0 is the bottom scanline

    # -- key handling ------------------------------------------------------------
    def handle_key(self, key: str) -> Optional[str]:
        if key == "n":
            self.renderer.next_camera()
            self.dirty = True
        elif key == "b":
            self.renderer.previous_camera()
            self.dirty = True
        elif key == "pageup":
            s = max(1, self.renderer.get_current_eye_samples_per_ommatidium())
            self.renderer.set_current_eye_samples_per_ommatidium(s * 2)
            self.dirty = True
        elif key == "pagedown":
            s = self.renderer.get_current_eye_samples_per_ommatidium()
            if s > 1:
                self.renderer.set_current_eye_samples_per_ommatidium(max(1, s // 2))
                self.dirty = True
        elif key == "c":
            path = f"gui-capture-{self.save_count}.ppm"
            self.renderer.save_frame_as(path)
            self.save_count += 1
            return path
        elif key == "escape":
            return "quit"
        else:
            self.controller.press(key)
        return None

    def tick(self) -> None:
        if self.controller.apply(self.renderer):
            self.dirty = True

    # -- matplotlib main loop ----------------------------------------------------
    def run(self, max_frames: Optional[int] = None, on_frame=None) -> None:
        """Interactive loop.  `max_frames` bounds the loop and `on_frame`
        (called as on_frame(frame_index, canvas) each iteration) lets tests
        and scripted captures drive the REAL event path headlessly — e.g.
        injecting matplotlib KeyEvents under the Agg backend where no window
        exists (tests/test_torch_viewer.py::test_viewer_run_loop_headless)."""
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 6))
        fig.canvas.manager.set_window_title("CompoundRay viewer")
        im = ax.imshow(self.frame())
        ax.set_axis_off()
        state = {"quit": False}

        def on_press(event):
            if event.key is None:
                return
            r = self.handle_key(event.key)
            if r == "quit":
                state["quit"] = True

        def on_release(event):
            if event.key:
                self.controller.release(event.key)

        fig.canvas.mpl_connect("key_press_event", on_press)
        fig.canvas.mpl_connect("key_release_event", on_release)
        plt.ion()
        plt.show()
        frame_i = 0
        while not state["quit"] and plt.fignum_exists(fig.number):
            if on_frame is not None:
                on_frame(frame_i, fig.canvas)
            self.tick()
            if self.dirty or self.renderer.is_compound_eye_active():
                im.set_data(self.frame())
                name = self.renderer.get_current_camera_name()
                ax.set_title(
                    f"{name}  ({self.renderer.get_current_eye_samples_per_ommatidium()} "
                    "samples/omm)" if self.renderer.is_compound_eye_active()
                    else name
                )
                fig.canvas.draw_idle()
            fig.canvas.flush_events()
            frame_i += 1
            if max_frames is not None and frame_i >= max_frames:
                break
            time.sleep(0.01)
        plt.close(fig)


    def run_web(self, port: int = 8988, max_frames: Optional[int] = None):
        """Serve the viewer as a live browser window (matplotlib WebAgg).

        The browser page carries the real interaction path: keydown events
        go over the WebAgg websocket into the same handle_key/controller
        code the desktop window uses.  The render loop rides a backend
        timer inside the tornado event loop — no threads touch matplotlib.
        `max_frames` stops the timer (the server keeps serving the last
        frame) so scripted sessions terminate deterministically."""
        import matplotlib

        matplotlib.rcParams["webagg.port"] = port
        matplotlib.rcParams["webagg.open_in_browser"] = False
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 6))
        im = ax.imshow(self.frame())
        ax.set_axis_off()
        state = {"quit": False, "frame": 0}

        def on_press(event):
            if event.key is None:
                return
            if self.handle_key(event.key) == "quit":
                state["quit"] = True
                plt.close(fig)
                # closing the figure does not stop WebAgg's tornado loop;
                # Esc must actually end the serving process (gui.cpp:94)
                import tornado.ioloop

                tornado.ioloop.IOLoop.current().stop()

        def on_release(event):
            if event.key:
                self.controller.release(event.key)

        fig.canvas.mpl_connect("key_press_event", on_press)
        fig.canvas.mpl_connect("key_release_event", on_release)

        timer = fig.canvas.new_timer(interval=30)

        def tick():
            if state["quit"]:
                timer.stop()
                return
            self.tick()
            if self.dirty or self.renderer.is_compound_eye_active():
                im.set_data(self.frame())
                name = self.renderer.get_current_camera_name()
                ax.set_title(
                    f"{name}  "
                    f"({self.renderer.get_current_eye_samples_per_ommatidium()} "
                    "samples/omm)" if self.renderer.is_compound_eye_active()
                    else name
                )
                fig.canvas.draw_idle()
            state["frame"] += 1
            if max_frames is not None and state["frame"] >= max_frames:
                timer.stop()

        timer.add_callback(tick)
        timer.start()
        print(f"[PyEye] web viewer at http://localhost:{port}/", flush=True)
        plt.show()  # serves until the process is interrupted / Esc quits


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-f", "--file", required=True, help="glTF scene")
    ap.add_argument("-W", "--width", type=int, default=400)
    ap.add_argument("-H", "--height", type=int, default=300)
    ap.add_argument("--web", action="store_true",
                    help="serve an interactive browser window (WebAgg) "
                         "instead of opening a desktop one")
    ap.add_argument("--port", type=int, default=8988)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda)")
    args = ap.parse_args(argv)
    if args.web:
        import matplotlib

        matplotlib.use("webagg")
    r = EyeRenderer(verbose=True, device=args.device)
    r.load_gltf_scene(args.file)
    v = Viewer(r, args.width, args.height)
    if args.web:
        v.run_web(port=args.port)
    else:
        v.run()


if __name__ == "__main__":
    main()

"""The port of autoware_vision_pilot_tpu/utils/manual_audit.py.

Frame-by-frame manual GT audit tool (P19 parity:
Models/data_utils/manual_audit_app.py).

The reference is a tkinter app binding keys 1/2/3 to accept / reject /
save-and-quit over an image folder, with a resumable ``audit_state.json``
(accepted/rejected lists + current index). Here the session logic is a
standalone, headless-testable class (`AuditSession`) and the GUI is a
thin cv2 frontend (`run_audit_app`) — tkinter is not assumed present on
the training hosts.

Keys: 1 = accept, 2 = reject, 3/q/ESC = save & quit,
      b = back (undo last decision).
"""
from __future__ import annotations

import json
import pathlib
from typing import List, Optional

STATE_FILE = "audit_state.json"
IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


class AuditSession:
    """Resumable accept/reject audit over an ordered image list."""

    def __init__(self, folder: str | pathlib.Path,
                 state_file: Optional[str | pathlib.Path] = None):
        self.folder = pathlib.Path(folder)
        self.state_path = pathlib.Path(
            state_file) if state_file else self.folder / STATE_FILE
        self.image_files: List[str] = sorted(
            p.name for p in self.folder.iterdir()
            if p.suffix.lower() in IMAGE_EXTS)
        self.accepted: List[str] = []
        self.rejected: List[str] = []
        self.current_index = 0
        self._maybe_resume()

    def _maybe_resume(self):
        if not self.state_path.exists():
            return
        state = json.loads(self.state_path.read_text())
        self.accepted = [f for f in state.get("accepted", [])
                         if f in self.image_files]
        self.rejected = [f for f in state.get("rejected", [])
                         if f in self.image_files]
        self.current_index = min(int(state.get("current_index", 0)),
                                 len(self.image_files))

    @property
    def done(self) -> bool:
        return self.current_index >= len(self.image_files)

    @property
    def current(self) -> Optional[str]:
        return (None if self.done
                else self.image_files[self.current_index])

    def accept(self):
        if not self.done:
            self.accepted.append(self.current)
            self.current_index += 1

    def reject(self):
        if not self.done:
            self.rejected.append(self.current)
            self.current_index += 1

    def back(self):
        """Undo the most recent decision (improvement over the reference,
        which cannot revisit a frame)."""
        if self.current_index == 0:
            return
        self.current_index -= 1
        name = self.image_files[self.current_index]
        if self.accepted and self.accepted[-1] == name:
            self.accepted.pop()
        elif self.rejected and self.rejected[-1] == name:
            self.rejected.pop()

    def save(self):
        """Persist state for resume (reference save_state :222)."""
        self.state_path.write_text(json.dumps({
            "accepted": self.accepted,
            "rejected": self.rejected,
            "current_index": self.current_index,
        }, indent=2))

    def summary(self) -> dict:
        return {"accepted": len(self.accepted),
                "rejected": len(self.rejected),
                "remaining": len(self.image_files) - self.current_index,
                "total": len(self.image_files)}


def run_audit_app(folder: str, state_file: Optional[str] = None,
                  window: str = "manual_audit"):  # pragma: no cover - GUI
    """cv2 frontend: show each frame with a live counter overlay;
    keyboard drives the session. Requires a display."""
    import cv2

    sess = AuditSession(folder, state_file)
    while not sess.done:
        img = cv2.imread(str(sess.folder / sess.current))
        if img is None:
            sess.reject()
            continue
        s = sess.summary()
        hud = (f"[{sess.current_index + 1}/{s['total']}] "
               f"acc={s['accepted']} rej={s['rejected']}  "
               f"1=accept 2=reject b=back 3/q=quit")
        cv2.putText(img, hud, (10, 28), cv2.FONT_HERSHEY_SIMPLEX,
                    0.7, (0, 255, 0), 2)
        cv2.imshow(window, img)
        k = cv2.waitKey(0) & 0xFF
        if k == ord("1"):
            sess.accept()
        elif k == ord("2"):
            sess.reject()
        elif k == ord("b"):
            sess.back()
        elif k in (ord("3"), ord("q"), 27):
            break
    sess.save()
    cv2.destroyAllWindows()
    print(json.dumps(sess.summary()))
    return sess


if __name__ == "__main__":  # pragma: no cover
    import sys
    run_audit_app(sys.argv[1] if len(sys.argv) > 1 else ".")

"""The CLI's live viewer (``--present``) in a child process, driven over HTTP
as a page would.

It drives every run whose screenshot is held bit for bit against one
rank's: ``tests/test_torch_present_ranks.py`` (gloo CPU ranks,
``--device cpu --devices 2``) and ``chip_smoke.py`` phase 6j (two cards).
``run_script`` sends each step of ``SCRIPT`` once the accumulation is full
(``PresentCli.settled``: a publication at ``spp`` frames whose ``/stats``
did not move while its PNG was read, and whose PNG differs from the last
step's), so that every run renders the same frames whatever its speed;
after the last step, a PNG screenshot, it sends SIGINT, as ctrl-c does.

No JAX here: the module is the port's, and both the CPU tests and the
card's smoke test read it.
"""

from __future__ import annotations

import json
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# sent one at a time, each once the accumulation is full; the frames after
# the orbit's are NO_CACHE, whose bands are the whole frame's bit for bit
SCRIPT = [("control", "op=orbit&dx=0.1&dy=0.05"), ("set", "key=render_mode&value=NO_CACHE"),
          ("action", "op=reset_cache"), ("action", "op=screenshot_png")]
STEP_TIMEOUT_S = 120.0


class PresentCli:
    """``python -m nrc_tpu_torch.app.cli ARGV --present --port 0 --spp SPP
    --output PREFIX`` in a child process from the repository's root, its
    output and errors read on threads into ``out`` and ``err``. Every wait
    ends within ``step_timeout`` seconds, or where the CLI ends."""

    def __init__(self, argv, prefix, spp: int, step_timeout: float = STEP_TIMEOUT_S):
        self.spp, self.step_timeout = spp, step_timeout
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "nrc_tpu_torch.app.cli", *argv, "--present", "--port", "0", "--spp", str(spp),
             "--output", str(prefix)], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.out, self.err = [], []
        for stream, lines in ((self.proc.stdout, self.out), (self.proc.stderr, self.err)):
            threading.Thread(target=lambda s=stream, ls=lines: ls.extend(iter(s.readline, "")), daemon=True).start()
        self._url = None

    def until(self, cond, what):
        """``cond()``'s first true value, polled every 0.1 s."""
        deadline = time.monotonic() + self.step_timeout
        while True:
            got = cond()
            if got:
                return got
            if self.proc.poll() is not None:
                raise RuntimeError(f"the CLI ended (exit code {self.proc.returncode}) while waiting for {what}: "
                                   f"{''.join(self.err)[-4000:]}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"the CLI: no {what} within {self.step_timeout:g} s")
            time.sleep(0.1)

    @property
    def url(self) -> str:
        """The viewer's address, as the CLI prints it."""
        if self._url is None:
            line = self.until(lambda: next((ln for ln in list(self.out) if ln.startswith("presenting at ")), None),
                              "URL")
            self._url = line.split()[2]
        return self._url

    def get(self, path: str) -> bytes:
        with urllib.request.urlopen(self.url + path, timeout=30) as resp:
            return resp.read()

    def settled(self, last):
        """The PNG of a publication at ``spp`` frames that differs from
        ``last``: the loop has applied the last step and accumulated again."""
        def ready():
            before = json.loads(self.get("stats"))
            if before["iteration"] != self.spp:
                return None
            png = self.get("frame.png")
            return png if json.loads(self.get("stats")) == before and png and png != last else None
        return self.until(ready, "new accumulated frame")

    def wait(self, timeout: float) -> int:
        """The CLI's exit code; killed after ``timeout`` seconds."""
        try:
            return self.proc.wait(timeout)
        finally:
            self.close()

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def run_script(argv, prefix, spp: int, step_timeout: float = STEP_TIMEOUT_S):
    """``SCRIPT`` through the viewer of ``PresentCli(argv, prefix, spp)``,
    then SIGINT: the screenshot's bytes, the CLI's exit code, its output and
    its errors."""
    cli = PresentCli(argv, prefix, spp, step_timeout)
    try:
        png = cli.settled(None)
        for endpoint, query in SCRIPT[:-1]:
            cli.get(f"{endpoint}?{query}")
            png = cli.settled(png)
        cli.get("{}?{}".format(*SCRIPT[-1]))
        shot = f"{prefix}_{spp}spp.png"
        # the loop prints the path once the file is written
        cli.until(lambda: any(line.strip() == shot for line in list(cli.out)), "screenshot")
        data = Path(shot).read_bytes()
        cli.proc.send_signal(signal.SIGINT)
        code = cli.wait(step_timeout)
    finally:
        cli.close()
    return data, code, "".join(cli.out), "".join(cli.err)

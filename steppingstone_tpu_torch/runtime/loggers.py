"""progress.csv + console logging, drop-in compatible with the reference
(own copy of steppingstone_tpu/runtime/loggers.py).

Schema and console line format match `common/csv_utils.py:16-68` exactly
(columns iter, total_num_steps, fps, entropy, value_loss, action_loss,
{mean,median,min,max}_rew, test_{...}_rew) so the reference's
`plot_from_csv.py` workflow keeps working on our runs.
"""

from __future__ import annotations

import csv
import os

import numpy as np


def _rotate(path):
    """Move an existing file to the first free `<path>.bak[.N]` slot so
    truncation never destroys a historical learning curve."""
    if not (os.path.exists(path) and os.path.getsize(path) > 0):
        return
    bak = path + ".bak"
    n = 1
    while os.path.exists(bak):
        n += 1
        bak = f"{path}.bak.{n}"
    os.replace(path, bak)


class CSVLogger:
    def __init__(self, log_dir, filename="progress.csv", resume=False):
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, filename)
        # append only when resuming (so the learning curve continues);
        # a fresh run pointed at an existing dir truncates — appending rows
        # under a stale header silently corrupts the curve
        had_rows = (
            resume and os.path.exists(path) and os.path.getsize(path) > 0
        )
        self._expected_header = None
        if had_rows:
            with open(path, newline="") as f:
                self._expected_header = f.readline().strip().split(",")
        if not had_rows:
            _rotate(path)  # preserve any prior curve instead of erasing it
        self.csvfile = open(path, "a" if had_rows else "w", newline="")
        self._header_written = had_rows
        self.writer = None

    def _expand_stats(self, data):
        for group, prefix in (("stats", ""), ("test_stats", "test_")):
            if group in data:
                for key, values in data[group].items():
                    if values is None:
                        # stale between eval intervals: blank, not repeated
                        # (the reference evaluates every update; with
                        # test_interval > 1 repeating old numbers misleads)
                        for agg in ("mean", "median", "min", "max"):
                            data[f"{prefix}{agg}_{key}"] = ""
                        continue
                    values = np.asarray(values)
                    if values.size == 0:
                        values = np.array([0.0])
                    data[prefix + "mean_" + key] = float(np.mean(values))
                    data[prefix + "median_" + key] = float(np.median(values))
                    data[prefix + "min_" + key] = float(np.min(values))
                    data[prefix + "max_" + key] = float(np.max(values))
                del data[group]
        return data

    def log_epoch(self, data: dict):
        data = self._expand_stats(dict(data))
        if self.writer is None:
            fields = list(data)
            if self._expected_header is not None and self._expected_header != fields:
                # resumed against a file with a different column set: rotate
                # the old curve aside and start fresh rather than misalign
                # rows under the old header (or silently erase history)
                name = self.csvfile.name
                self.csvfile.close()
                _rotate(name)
                self.csvfile = open(name, "w", newline="")
                self._header_written = False
            self.writer = csv.DictWriter(self.csvfile, fieldnames=fields)
            if not self._header_written:
                self.writer.writeheader()
                self._header_written = True
        self.writer.writerow(data)
        self.csvfile.flush()
        return data

    def close(self):
        self.csvfile.close()


class ConsoleCSVLogger(CSVLogger):
    """Reference `ConsoleCSVLogger` (csv_utils.py:41-68)."""

    def __init__(self, log_dir, console_log_interval=1, **kw):
        super().__init__(log_dir, **kw)
        self.console_log_interval = console_log_interval

    def log_epoch(self, data: dict):
        data = super().log_epoch(data)
        f = lambda x: float("nan") if x in ("", None) else float(x)
        if data["iter"] % self.console_log_interval == 0:
            print(
                "Updates {}, num timesteps {}, FPS {}, "
                "mean/median reward {:.1f}/{:.1f}, min/max reward {:.1f}/{:.1f}, "
                "test_mean/median reward {:.1f}/{:.1f}, "
                "test_min/max reward {:.1f}/{:.1f}, "
                "entropy {:.5f}, value loss {:.5f}, policy loss {:.5f}".format(
                    data["iter"], data["total_num_steps"], data["fps"],
                    data["mean_rew"], data["median_rew"],
                    data["min_rew"], data["max_rew"],
                    f(data.get("test_mean_rew", 0.0)), f(data.get("test_median_rew", 0.0)),
                    f(data.get("test_min_rew", 0.0)), f(data.get("test_max_rew", 0.0)),
                    data["entropy"], data["value_loss"], data["action_loss"],
                ),
                flush=True,
            )
        return data

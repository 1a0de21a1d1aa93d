"""Evaluation TSV log: ``walltime<TAB>step<TAB>name:value...`` per line.

Same format as the reference's evaluation thread output (runner.py:184-187,
394-399), so existing plotting scripts keep working.

The file is opened in append mode, so a resumed run extends its predecessor's
log.  On restore (auto-resume or a guardian rollback) the runner calls
``truncate_after(restored_step)`` first: rows written beyond the restored
step belong to a timeline the run just abandoned, and appending after them
would leave duplicate/interleaved step columns that break every downstream
``sort -n``/plot assumption.
"""

import os
import time


class EvalFile:
    def __init__(self, path):
        self.path = path
        self._fd = open(path, "a") if path else None
        self._start = time.time()

    def truncate_after(self, step):
        """Drop rows with step > ``step`` (atomic rewrite); returns the
        number of rows dropped.  Malformed lines are conservatively kept."""
        if self._fd is None or not os.path.exists(self.path):
            return 0
        self._fd.close()
        with open(self.path) as fd:
            lines = fd.readlines()
        kept, dropped = [], 0
        for line in lines:
            fields = line.split("\t")
            try:
                row_step = int(fields[1])
            except (IndexError, ValueError):
                kept.append(line)
                continue
            if row_step <= step:
                kept.append(line)
            else:
                dropped += 1
        if dropped:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as fd:
                fd.writelines(kept)
            os.replace(tmp, self.path)
        self._fd = open(self.path, "a")
        return dropped

    def append(self, step, metrics):
        if self._fd is None:
            return
        fields = ["%.6f" % (time.time() - self._start), str(int(step))]
        # Integral metrics (e.g. the chaos_regime index column) keep their
        # int spelling so downstream `cut`/`awk` filters can match exactly;
        # everything else stays the reference's float repr.
        fields += [
            "%s:%s" % (name, int(value) if isinstance(value, int) and not isinstance(value, bool)
                       else float(value))
            for name, value in sorted(metrics.items())
        ]
        self._fd.write("\t".join(fields) + "\n")
        self._fd.flush()

    def close(self):
        if self._fd is not None:
            self._fd.close()
            self._fd = None

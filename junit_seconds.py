"""Sum the test-seconds of pytest ``--junitxml`` files: the whole run's, the
PyTorch port's (``tests/test_torch_*.py``) and the costliest files', beside
the run's wall time and its counts. One JSON line per file:

    python junit_seconds.py run.xml [other.xml ...]
"""
import json
import sys
import xml.etree.ElementTree as ET
from collections import Counter

PORT = "tests.test_torch_"


def summary(path, top=8):
    suite = next(ET.parse(path).getroot().iter("testsuite"))
    files = Counter()
    for case in suite.iter("testcase"):
        files[case.get("classname", "").split("::")[0]] += float(case.get("time") or 0.0)
    counts = {k: int(suite.get(k, 0)) for k in ("tests", "errors", "failures", "skipped")}
    return {
        "file": str(path),
        "wall_s": float(suite.get("time", 0.0)),
        "passed": counts["tests"] - counts["errors"] - counts["failures"] - counts["skipped"],
        **counts,
        "test_seconds": round(sum(files.values()), 3),
        "port_test_seconds": round(sum(v for k, v in files.items() if k.startswith(PORT)), 3),
        "costliest": {k: round(v, 3) for k, v in files.most_common(top)},
    }


if __name__ == "__main__":
    for path in sys.argv[1:]:
        print(json.dumps(summary(path)))

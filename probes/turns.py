"""chip_smoke.py phases of several source trees in turns, each run in a
process of its own from its tree's root (so each tree builds and loads its
own kernels): for every directory given, in the order given, import that
tree's chip_smoke and run the named phases, printing their JSON records
with the tree's directory added.  To compare two commits on one card,
unpack the parent with ``git archive`` into a gitignored directory and run
parent, change, change, parent.  Run from the repository root on a CUDA
card: ``python3 probes/turns.py vit_train,attribution DIR [DIR ...]``."""

import json
import subprocess
import sys

RUN = ("import sys, torch; sys.path.insert(0, '.'); import chip_smoke as c; "
       "torch.backends.cuda.matmul.allow_tf32 = False; "
       "torch.backends.cudnn.allow_tf32 = False; info = {'card': c.card()}; "
       "[getattr(c, 'phase_' + p)(info) for p in sys.argv[1].split(',')]")


def main():
    phases, trees = sys.argv[1], sys.argv[2:]
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", RUN, phases], cwd=tree,
                              capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(json.dumps({"tree": tree, **json.loads(line)}), flush=True)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())

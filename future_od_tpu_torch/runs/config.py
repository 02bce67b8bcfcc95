"""Repo-root-relative paths of the run scripts (the port's own copy of the
repo's `config.py`). A caller may point them elsewhere by assigning to the
dict before a script's `main()` runs."""
import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

config = {
    "visualization_path": f"{REPO_ROOT}/visualization",
    "checkpoint_path": f"{REPO_ROOT}/checkpoints",
    "nuscenes_path": f"{REPO_ROOT}/data/nuscenes",
    "nuimages_path": f"{REPO_ROOT}/data/nuimages",
}

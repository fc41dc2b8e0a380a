"""3D cut-cell BE heat step scaling (the 3D analogue of heat_scaling.py):
ms/step and CG iterations vs grid size on one GPU, embedded sphere, f32 —
writes heat_scaling3d.csv.

Reference analogue: benchmark/Heat3D.jl (accuracy only — the reference
publishes no timings).

Run:  python benchmarks/heat_scaling3d.py [max_n]   (needs a GPU)
"""

import sys as _sys, os as _os
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

from benchmarks.heat_scaling import sweep

if __name__ == "__main__":
    max_n = int(_sys.argv[1]) if len(_sys.argv) > 1 else 256
    sweep([n for n in (64, 128, 192, 256) if n <= max_n], 3,
          "heat_scaling3d.csv")

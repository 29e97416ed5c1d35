"""The benchmark of facedeform_tpu_torch on one NVIDIA H100.

One command runs one cell once:

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations and metrics are listed in BENCHMARK.json at the
root of the repository.  Everything that belongs to one configuration,
traffic mix, kind of loop, per-layer metric, roofline count or cell limit
sits in a file of its own, found by its name:

    configs/<config>.json     the deployment: its scene, reference family,
                              sizes, the program's config, precision
    scenes/<scene>.py         make(config, seed, device): mesh, rig, shapes
    reference/<family>.py     Reference: the plain reference's outputs
    traffic/<mix>.json        the parameters of one mix, and its "loop"
    loops/<loop>.py           Loop (the generator and the program's entry)
                              and compare (the numbers), see drive.py
    metrics/<metric>.py       read(run) -> number or None
    roofline/<layer>.py       work(ctx) -> operations and bytes the layer needs
    limits/<cell>.json        the limit of each number the comparison reads

The yardstick (inputs, traffic, the plain reference, the comparison, the
peaks and the roofline counts) lives here; the program under test,
facedeform_tpu_torch, is imported only by drive.py and the loops.
"""

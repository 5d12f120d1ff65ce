"""equipotential.cloud_ms (ms): the program's `cloud` stage in run_equipotential
(StageTimer, the device synchronised at both ends): the four families'
inverse-eigenvalue clouds, one aberth.cu launch a family
(companion.inverse_cloud_split and inverse_cloud), each ending in its copy to
the host; mean per measured job."""

from benchmarks.harness import spans


def read(ctx):
    return spans.mean_ms(ctx, ("cloud",))

"""Host seconds of the scene build's BVH and treelet steps, as the port's
``DynamicScene.build`` records them in ``SceneData.host["build_seconds"]``."""


def read(run):
    return (run.build_s, "s") if run.build_s > 0 else None

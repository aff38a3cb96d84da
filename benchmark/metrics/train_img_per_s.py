"""``train_img_per_s``: images of every train step dispatched in the
window over the seconds from its start to the synchronize that ends it."""


def read(run, name):
    if run["kind"] != "train" or not run["steps"]:
        return None
    return run["images"] / run["seconds"]

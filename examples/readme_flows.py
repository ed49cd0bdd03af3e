"""The reference README's two flows (reference Readme.md:8-26), verbatim on
this framework's containers. Run from the repo root:

    python examples/readme_flows.py ASSET_DIR
"""

import os, sys, tempfile
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


from stepth import DepthFrame

from stepth.utils.scenes import reference_assets_dir

assets = sys.argv[1] if len(sys.argv) > 1 else reference_assets_dir()
out = tempfile.gettempdir()
precision = (36, 36, 36)  # 255//7 per channel, as the README suggests

# Flow 1: derive depth from the additional view and save it.
img = DepthFrame.open(f"{assets}/main.jpg")
img = img.open_depth_from_additional(f"{assets}/additional.jpg", precision)
img.save_depth(os.path.join(out, "depth.png"))

# Flow 2: load a depth map, invert, select the foreground, mask the photo.
img2 = DepthFrame.open(f"{assets}/main.jpg").open_depth(os.path.join(out, "depth.png"))
mask = img2.invert_depth().select_foreground().apply_mask()
mask.save(os.path.join(out, "foreground.png"))  # quirk Q7: saves the masked image

print(f"wrote depth.png and foreground.png to {out}")

"""End-to-end API walkthrough (python-examples/primary-example.py:18-98)
on the port (examples/primary_example.py).

The reference script's flow through the ctypes-compatible shim: load a
scene ($CR_SCENE, glTF or .blend), cycle the cameras, render, save PPMs
under test-images/, and raise a compound eye's sample rate.  The original
script runs unchanged if its CDLL(...) line becomes load_eye_renderer().

    python -m compound_ray_tpu_torch.examples.primary_example [--device cuda]
"""

import argparse
import os
from ctypes import c_char_p

from compound_ray_tpu_torch import eye_tools as eyeTools
from compound_ray_tpu_torch.api.shim import load_eye_renderer
from compound_ray_tpu_torch.examples import add_device_argument, reference_data


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    scene = os.environ.get("CR_SCENE",
                           reference_data("test-scene/test-scene.gltf"))
    os.makedirs("test-images", exist_ok=True)

    eyeRenderer = load_eye_renderer(device=args.device)
    print("Successfully loaded", eyeRenderer)
    eyeTools.configureFunctions(eyeRenderer)

    eyeRenderer.loadGlTFscene(c_char_p(scene.encode()))

    renderWidth, renderHeight = 200, 200
    eyeTools.setRenderSize(eyeRenderer, renderWidth, renderHeight)

    for i in range(min(5, eyeRenderer.getCameraCount())):
        renderTime = eyeRenderer.renderFrame()
        print("View from camera '", eyeRenderer.getCurrentCameraName(),
              "' rendered in ", renderTime, "ms")
        eyeRenderer.displayFrame()
        eyeRenderer.saveFrameAs(
            c_char_p(f"test-images/test-image-{i}.ppm".encode())
        )
        frameData = eyeRenderer.getFramePointer()
        print("FrameData shape:", frameData.shape)

        if eyeRenderer.isCompoundEyeActive():
            print("This one's a compound eye; raising the sample rate...")
            eyeRenderer.setCurrentEyeSamplesPerOmmatidium(100)
            eyeRenderer.renderFrame()
            eyeRenderer.saveFrameAs(
                c_char_p(f"test-images/test-image-{i}-100samples.ppm".encode())
            )
        eyeRenderer.nextCamera()

    eyeRenderer.stop()


if __name__ == "__main__":
    main()

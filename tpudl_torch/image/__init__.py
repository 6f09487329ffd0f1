"""Image I/O (``imageIO``) and the device-side prologue (``ops``)."""

from tpudl_torch.image import imageIO, ops
from tpudl_torch.image.imageIO import (
    ImageType,
    imageArrayToStruct,
    imageStructToArray,
    imageTypeByName,
    imageTypeByOrdinal,
    readImages,
    readImagesWithCustomFn,
    resizeImage,
)

__all__ = ["imageIO", "ops", "ImageType", "imageArrayToStruct",
           "imageStructToArray", "imageTypeByName", "imageTypeByOrdinal",
           "readImages", "readImagesWithCustomFn", "resizeImage"]

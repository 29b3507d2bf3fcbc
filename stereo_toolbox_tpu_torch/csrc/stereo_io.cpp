// stereo_io: native decode + normalize runtime of the stereo port's data
// layer (a copy of the JAX package's native/stereo_io.cpp, the same code).
//
// It replaces the hot host-side path of the original toolbox's data layer
// (datasets/utils.py:25-69 pfm_imread/get_transform and the PIL
// Image.open calls in every dataset loader): image decode and float
// conversion run in C++, so the loader's worker threads decode outside the
// GIL (ctypes releases it for the duration of each call). No device path
// depends on it.
//
// C ABI only, bound from Python with ctypes
// (stereo_toolbox_tpu_torch/native/__init__.py). Every function returns 0 on
// success, nonzero on failure; the error text is retrievable per thread via
// sio_last_error().
//
// Supported formats:
//   * PFM ("PF"/"Pf", endian from scale sign, stored bottom-up -> flipped to
//     top-down on decode; parity with datasets/utils.py:25-59)
//   * PNG via libpng (8/16-bit, gray/palette/RGB/RGBA)
//   * JPEG via libjpeg (baseline + progressive, to RGB)
//
// Build: g++ -O3 -fPIC -shared stereo_io.cpp -lpng -ljpeg -o libstereo_io.so

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <string>

#include <png.h>
extern "C" {
#include <jpeglib.h>
}

namespace {

thread_local std::string g_error;

void set_error(const std::string& msg) { g_error = msg; }

struct File {
    FILE* f = nullptr;
    explicit File(const char* path, const char* mode) {
        f = std::fopen(path, mode);
    }
    ~File() {
        if (f) std::fclose(f);
    }
    File(const File&) = delete;
    File& operator=(const File&) = delete;
};

// ---------------------------------------------------------------------------
// Format sniffing
// ---------------------------------------------------------------------------

enum Format { FMT_UNKNOWN = 0, FMT_PNG = 1, FMT_JPEG = 2, FMT_PFM = 3 };

Format sniff(FILE* f) {
    unsigned char magic[8] = {0};
    size_t n = std::fread(magic, 1, 8, f);
    std::rewind(f);
    if (n >= 8 && !std::memcmp(magic, "\x89PNG\r\n\x1a\n", 8)) return FMT_PNG;
    if (n >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) return FMT_JPEG;
    if (n >= 2 && magic[0] == 'P' && (magic[1] == 'F' || magic[1] == 'f'))
        return FMT_PFM;
    return FMT_UNKNOWN;
}

// ---------------------------------------------------------------------------
// PFM
// ---------------------------------------------------------------------------

// Reads one whitespace-delimited token, skipping single-char whitespace the
// way the reference's readline-based parser tolerates ("PF\n", "w h\n",
// "scale\n").
bool pfm_token(FILE* f, char* buf, size_t cap) {
    int c;
    do {
        c = std::fgetc(f);
    } while (c != EOF && std::isspace(c));
    if (c == EOF) return false;
    size_t i = 0;
    while (c != EOF && !std::isspace(c) && i + 1 < cap) {
        buf[i++] = static_cast<char>(c);
        c = std::fgetc(f);
    }
    buf[i] = '\0';
    return true;
}

struct PfmHeader {
    int width = 0, height = 0, channels = 0;
    float scale = 0.f;
    long data_offset = 0;
};

bool pfm_read_header(FILE* f, const char* path, PfmHeader* hdr) {
    char tok[64];
    if (!pfm_token(f, tok, sizeof tok) ||
        (std::strcmp(tok, "PF") && std::strcmp(tok, "Pf"))) {
        set_error(std::string(path) + ": not a PFM file");
        return false;
    }
    hdr->channels = std::strcmp(tok, "PF") == 0 ? 3 : 1;
    if (!pfm_token(f, tok, sizeof tok)) return false;
    hdr->width = std::atoi(tok);
    if (!pfm_token(f, tok, sizeof tok)) return false;
    hdr->height = std::atoi(tok);
    if (!pfm_token(f, tok, sizeof tok)) return false;
    hdr->scale = static_cast<float>(std::atof(tok));
    if (hdr->width <= 0 || hdr->height <= 0) {
        set_error(std::string(path) + ": malformed PFM dims");
        return false;
    }
    // Exactly one whitespace char separates the header from the raster; the
    // token reader already consumed it.
    hdr->data_offset = std::ftell(f);
    return true;
}

// Decode the PFM raster into `out` (H*W*C float32), flipped so row 0 is the
// top row (PFM stores bottom-up; parity with np.flipud in pfm_imread).
bool pfm_decode(FILE* f, const char* path, const PfmHeader& hdr, float* out) {
    const size_t row_elems =
        static_cast<size_t>(hdr.width) * hdr.channels;
    const bool little = hdr.scale < 0.f;
    for (int y = hdr.height - 1; y >= 0; --y) {
        float* dst = out + static_cast<size_t>(y) * row_elems;
        if (std::fread(dst, 4, row_elems, f) != row_elems) {
            set_error(std::string(path) + ": truncated PFM raster");
            return false;
        }
        if (!little) {  // big-endian file → byteswap (host is little-endian)
            auto* p = reinterpret_cast<uint32_t*>(dst);
            for (size_t i = 0; i < row_elems; ++i)
                p[i] = __builtin_bswap32(p[i]);
        }
    }
    return true;
}

// ---------------------------------------------------------------------------
// PNG (libpng full API — the simplified API gamma-converts 16-bit data,
// which would corrupt raw disparity encodings like KITTI's uint16/256)
// ---------------------------------------------------------------------------

struct PngReader {
    png_structp png = nullptr;
    png_infop info = nullptr;
    ~PngReader() {
        if (png) png_destroy_read_struct(&png, info ? &info : nullptr,
                                         nullptr);
    }
};

bool png_open(FILE* f, const char* path, PngReader* r) {
    r->png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr,
                                    nullptr);
    if (!r->png) return false;
    r->info = png_create_info_struct(r->png);
    if (!r->info) return false;
    if (setjmp(png_jmpbuf(r->png))) {
        set_error(std::string(path) + ": libpng decode error");
        return false;
    }
    png_init_io(r->png, f);
    png_read_info(r->png, r->info);
    return true;
}

// rows helper: fill row pointers into a contiguous buffer
bool png_read_rows(PngReader* r, const char* path, unsigned char* out,
                   size_t rowbytes, int height) {
    if (setjmp(png_jmpbuf(r->png))) {
        set_error(std::string(path) + ": libpng decode error");
        return false;
    }
    for (int y = 0; y < height; ++y)
        png_read_row(r->png, out + static_cast<size_t>(y) * rowbytes,
                     nullptr);
    return true;
}

// ---------------------------------------------------------------------------
// JPEG (libjpeg with setjmp error manager)
// ---------------------------------------------------------------------------

struct JpegErr {
    jpeg_error_mgr mgr;
    std::jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
    auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
    char msg[JMSG_LENGTH_MAX];
    (*cinfo->err->format_message)(cinfo, msg);
    set_error(std::string("libjpeg: ") + msg);
    std::longjmp(err->jb, 1);
}

}  // namespace

// ---------------------------------------------------------------------------
// Public C ABI
// ---------------------------------------------------------------------------

extern "C" {

const char* sio_last_error(void) { return g_error.c_str(); }

// Probe an image file: fills width/height/channels (as stored) and bitdepth
// (8, 16, or 32 for PFM float). Returns 0 on success.
int sio_image_info(const char* path, int* width, int* height, int* channels,
                   int* bitdepth) {
    File file(path, "rb");
    if (!file.f) {
        set_error(std::string(path) + ": cannot open");
        return 1;
    }
    switch (sniff(file.f)) {
        case FMT_PFM: {
            PfmHeader hdr;
            if (!pfm_read_header(file.f, path, &hdr)) return 1;
            *width = hdr.width;
            *height = hdr.height;
            *channels = hdr.channels;
            *bitdepth = 32;
            return 0;
        }
        case FMT_PNG: {
            PngReader r;
            if (!png_open(file.f, path, &r)) return 1;
            *width = static_cast<int>(png_get_image_width(r.png, r.info));
            *height = static_cast<int>(png_get_image_height(r.png, r.info));
            int color = png_get_color_type(r.png, r.info);
            *bitdepth = png_get_bit_depth(r.png, r.info);
            switch (color) {
                case PNG_COLOR_TYPE_GRAY: *channels = 1; break;
                case PNG_COLOR_TYPE_GRAY_ALPHA: *channels = 2; break;
                case PNG_COLOR_TYPE_PALETTE:  // expanded to RGB on decode
                case PNG_COLOR_TYPE_RGB: *channels = 3; break;
                default: *channels = 4; break;
            }
            if (color == PNG_COLOR_TYPE_PALETTE) *bitdepth = 8;
            return 0;
        }
        case FMT_JPEG: {
            jpeg_decompress_struct cinfo;
            JpegErr jerr;
            cinfo.err = jpeg_std_error(&jerr.mgr);
            jerr.mgr.error_exit = jpeg_err_exit;
            if (setjmp(jerr.jb)) {
                jpeg_destroy_decompress(&cinfo);
                return 1;
            }
            jpeg_create_decompress(&cinfo);
            jpeg_stdio_src(&cinfo, file.f);
            jpeg_read_header(&cinfo, TRUE);
            *width = static_cast<int>(cinfo.image_width);
            *height = static_cast<int>(cinfo.image_height);
            *channels = cinfo.num_components;
            *bitdepth = 8;
            jpeg_destroy_decompress(&cinfo);
            return 0;
        }
        default:
            set_error(std::string(path) + ": unknown image format");
            return 1;
    }
}

// Decode a PFM file into `out` (height*width*channels float32, top-down).
// Caller sizes the buffer from sio_image_info. abs_scale receives |scale|.
int sio_decode_pfm(const char* path, float* out, float* abs_scale) {
    File file(path, "rb");
    if (!file.f) {
        set_error(std::string(path) + ": cannot open");
        return 1;
    }
    PfmHeader hdr;
    if (!pfm_read_header(file.f, path, &hdr)) return 1;
    if (abs_scale) *abs_scale = hdr.scale < 0 ? -hdr.scale : hdr.scale;
    return pfm_decode(file.f, path, hdr, out) ? 0 : 1;
}

// Decode any supported image as 8-bit RGB (HxWx3) into `out`.
// Palette is expanded; gray is replicated; alpha is dropped; 16-bit is
// scaled down to 8 (matching PIL Image.convert("RGB") for display images).
int sio_decode_rgb8(const char* path, unsigned char* out) {
    File file(path, "rb");
    if (!file.f) {
        set_error(std::string(path) + ": cannot open");
        return 1;
    }
    Format fmt = sniff(file.f);
    if (fmt == FMT_PNG) {
        PngReader r;
        if (!png_open(file.f, path, &r)) return 1;
        if (setjmp(png_jmpbuf(r.png))) {
            set_error(std::string(path) + ": libpng decode error");
            return 1;
        }
        png_set_palette_to_rgb(r.png);
        png_set_expand_gray_1_2_4_to_8(r.png);
        if (png_get_valid(r.png, r.info, PNG_INFO_tRNS))
            png_set_tRNS_to_alpha(r.png);
        png_set_strip_16(r.png);
        png_set_strip_alpha(r.png);
        png_set_gray_to_rgb(r.png);
        png_read_update_info(r.png, r.info);
        int h = static_cast<int>(png_get_image_height(r.png, r.info));
        size_t rowbytes = png_get_rowbytes(r.png, r.info);
        return png_read_rows(&r, path, out, rowbytes, h) ? 0 : 1;
    }
    if (fmt == FMT_JPEG) {
        jpeg_decompress_struct cinfo;
        JpegErr jerr;
        cinfo.err = jpeg_std_error(&jerr.mgr);
        jerr.mgr.error_exit = jpeg_err_exit;
        if (setjmp(jerr.jb)) {
            jpeg_destroy_decompress(&cinfo);
            return 1;
        }
        jpeg_create_decompress(&cinfo);
        jpeg_stdio_src(&cinfo, file.f);
        jpeg_read_header(&cinfo, TRUE);
        cinfo.out_color_space = JCS_RGB;
        jpeg_start_decompress(&cinfo);
        size_t rowbytes = static_cast<size_t>(cinfo.output_width) * 3;
        while (cinfo.output_scanline < cinfo.output_height) {
            unsigned char* row =
                out + static_cast<size_t>(cinfo.output_scanline) * rowbytes;
            jpeg_read_scanlines(&cinfo, &row, 1);
        }
        jpeg_finish_decompress(&cinfo);
        jpeg_destroy_decompress(&cinfo);
        return 0;
    }
    set_error(std::string(path) + ": sio_decode_rgb8 supports PNG/JPEG only");
    return 1;
}

// Decode a PNG preserving stored values (for disparity/mask PNGs: KITTI
// uint16/256, InStereo2k uint16/1024, Middlebury mask==255, ...).
// Output is uint8 or uint16 per sio_image_info's bitdepth, HxWxC
// (C as stored; palette expanded to RGB). 16-bit values are host-endian.
int sio_decode_raw(const char* path, void* out) {
    File file(path, "rb");
    if (!file.f) {
        set_error(std::string(path) + ": cannot open");
        return 1;
    }
    if (sniff(file.f) != FMT_PNG) {
        set_error(std::string(path) + ": sio_decode_raw supports PNG only");
        return 1;
    }
    PngReader r;
    if (!png_open(file.f, path, &r)) return 1;
    if (setjmp(png_jmpbuf(r.png))) {
        set_error(std::string(path) + ": libpng decode error");
        return 1;
    }
    png_set_palette_to_rgb(r.png);
    png_set_expand_gray_1_2_4_to_8(r.png);
    if (png_get_bit_depth(r.png, r.info) == 16)
        png_set_swap(r.png);  // PNG is big-endian; host is little-endian
    png_read_update_info(r.png, r.info);
    int h = static_cast<int>(png_get_image_height(r.png, r.info));
    size_t rowbytes = png_get_rowbytes(r.png, r.info);
    return png_read_rows(&r, path, static_cast<unsigned char*>(out),
                         rowbytes, h)
               ? 0
               : 1;
}

// Fused ToTensor + ImageNet normalize: uint8 HWC RGB → float32
// (x/255 - mean)/std, one pass (reference datasets/utils.py:62-69).
int sio_normalize_imagenet(const unsigned char* in, float* out,
                           long long n_pixels) {
    static const float kScale[3] = {1.f / (255.f * 0.229f),
                                    1.f / (255.f * 0.224f),
                                    1.f / (255.f * 0.225f)};
    static const float kBias[3] = {-0.485f / 0.229f, -0.456f / 0.224f,
                                   -0.406f / 0.225f};
    const long long n = n_pixels * 3;
    for (long long i = 0; i < n; i += 3) {
        out[i] = in[i] * kScale[0] + kBias[0];
        out[i + 1] = in[i + 1] * kScale[1] + kBias[1];
        out[i + 2] = in[i + 2] * kScale[2] + kBias[2];
    }
    return 0;
}

// Decode + normalize in one call (PNG/JPEG → ImageNet-normalized float32
// HxWx3). Avoids a Python round trip between decode and normalize.
int sio_load_image_normalized(const char* path, float* out,
                              unsigned char* scratch) {
    if (sio_decode_rgb8(path, scratch)) return 1;
    int w, h, c, depth;
    if (sio_image_info(path, &w, &h, &c, &depth)) return 1;
    return sio_normalize_imagenet(scratch, out,
                                  static_cast<long long>(w) * h);
}

}  // extern "C"

/* C ABI of the native host runtime (libs3dnative).
 *
 * The reference ships its render core as a C-ABI dylib resolved at runtime
 * (reference main.swift:96-98, render-cpp/render.cpp:264). This framework keeps
 * that shape: a native library loadable via dlopen/ctypes, exposing scene IO and
 * a CPU render core. The core is NOT a port of the reference's: it mirrors this
 * framework's device pipeline (structure-of-arrays scene, fixed-shape near-plane
 * clip prepass, per-triangle setup table, visibility resolve + deferred shading)
 * so the native and device implementations stay behavioral twins — the same
 * dual-implementation cross-check structure the reference uses between its Swift
 * and C++ cores (reference README.md:17).
 */
#ifndef S3D_NATIVE_H
#define S3D_NATIVE_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct s3d_scene s3d_scene; /* opaque */

typedef struct {
    float up, down, left, right;
    float mouse_x, mouse_y;
} s3d_input;

typedef struct {
    uint32_t *pixels;   /* H*W words, 0x00RRGGBB rows top-down */
    float *depth;       /* H*W 1/z, 0 = background (may be NULL) */
    uint32_t width;
    uint32_t height;
} s3d_framebuffer;

typedef struct {
    float near_plane;       /* 0.1 */
    float fov;              /* pi/5 */
    float speed;            /* 0.1 */
    float rotation_speed;   /* 0.3 */
    float min_area;         /* 10 */
    uint32_t background;    /* 0x001E1E1E */
    int bilinear;           /* 0 = reference-exact nearest ripmap fetch */
} s3d_config;

/* ---- scene IO (data.bin format, see utils/databin.py for the layout) ---- */
s3d_scene *s3d_scene_load(const char *path);
s3d_scene *s3d_scene_from_memory(const uint8_t *bytes, size_t len);
/* Build directly from structure-of-arrays buffers (all copied). attr_vec is RGB
 * or (u, v, 0); attr_tex is the texture index or -1. */
s3d_scene *s3d_scene_create(
    const float *vertices4, int64_t vertex_count,
    const int64_t *vertex_indices, int64_t vertex_index_count,
    const float *normals4, const float *attr_vec, const int64_t *attr_tex,
    int64_t attribute_count,
    const int64_t *attribute_indices,
    const uint32_t *texture_words, int64_t texture_count);
int s3d_scene_save(const s3d_scene *scene, const char *path);
void s3d_scene_free(s3d_scene *scene);

int64_t s3d_scene_vertex_count(const s3d_scene *scene);
int64_t s3d_scene_triangle_count(const s3d_scene *scene);
int64_t s3d_scene_texture_count(const s3d_scene *scene);
/* Returns NULL-terminated description of the last load error, or NULL. */
const char *s3d_last_error(void);

/* ---- camera ---- */
typedef struct {
    float position[3];
    float axis_x[3], axis_y[3], axis_z[3];
    float mouse[2];
    float matrix[12];  /* 3x4 row-major view matrix */
} s3d_camera;

void s3d_camera_init(s3d_camera *cam);
/* One frame of input (reference updateCamera, render/render.swift:113-135). */
void s3d_camera_update(s3d_camera *cam, const s3d_input *input,
                       const s3d_config *config, int force_update);

/* ---- render core ---- */
typedef struct s3d_renderer s3d_renderer; /* per-scene working memory */

s3d_renderer *s3d_renderer_create(const s3d_scene *scene);
void s3d_renderer_free(s3d_renderer *r);
/* Render one frame with the given 3x4 view matrix into fb (caller-allocated). */
void s3d_render(s3d_renderer *r, const float *matrix12,
                const s3d_config *config, s3d_framebuffer *fb);

/* Default config values (reference render/render.swift:32-41). */
void s3d_config_default(s3d_config *config);

/* ---- telemetry ---- */
double s3d_now(void); /* monotonic seconds */

#ifdef __cplusplus
}
#endif

#endif /* S3D_NATIVE_H */
